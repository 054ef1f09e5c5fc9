"""phaser_tpu_torch.kernels.stats (the connection test's statistics, float64)
against scipy.stats.binom and against phaser_tpu.kernels.stats (float32
jnp) on the same numpy inputs.  On CPU tensors the wrappers run their plain
versions; tests/test_torch_gpu.py holds the CUDA kernels against those.

Tolerances, each with its reason:
- against scipy: atol 1e-10 (both float64; the port's incomplete beta is
  a Lentz continued fraction to 1e-15 per term);
- against JAX's binom_cdf: atol 2e-4 for n < 200, the JAX package's own
  bound (tests/test_kernels.py:91), since JAX computes in float32;
- pruning decisions: equal to JAX's outside JAX's `uncertain` band, and
  equal to scipy's everywhere (float64 leaves no pair within 1e-13 of a
  threshold undecided);
- noise_from_counts: rel 1e-6 against JAX (float32 sums there)."""

import numpy as np
import pytest
import torch
from scipy.stats import binom

import jax.numpy as jnp
from phaser_tpu.kernels import stats as J
from phaser_tpu_torch.kernels import stats as S

NOISE = 0.0037


@pytest.mark.parametrize("n_max", [200, 1000, 5000])
def test_binom_cdf_matches_scipy(n_max):
    rng = np.random.default_rng(n_max)
    n = rng.integers(1, n_max, 4000)
    k = (n * rng.random(4000)).astype(int)
    p = rng.uniform(0.001, 0.999, 4000)
    got = S.binom_cdf(torch.from_numpy(k), torch.from_numpy(n),
                      torch.from_numpy(p))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), binom.cdf(k, n, p), rtol=0,
                               atol=1e-10)


def test_binom_cdf_converges_at_the_mean_for_n_10000():
    """k at the mean is where the continued fraction is longest: for
    n = 10,000 it stays within 1e-10 of scipy and far under the cap."""
    rng = np.random.default_rng(1)
    n = np.full(500, 10_000)
    p = rng.uniform(0.001, 0.999, 500)
    k = np.floor(n * p).astype(int)
    args = [torch.from_numpy(x) for x in (k, n, p)]
    np.testing.assert_allclose(S.binom_cdf(*args).numpy(),
                               binom.cdf(k, n, p), rtol=0, atol=1e-10)
    terms = S.binom_cdf_terms(*args)
    assert 0 < int(terms.max()) < S.BETACF_MAX_ITER // 4


def test_binom_cdf_edge_rules_match_jax_and_scipy():
    """k >= n gives 1, k < 0 gives 0, p of 0 and 1, n = 0, fractional k
    floored (atol 1e-10 against scipy, 2e-4 against JAX's float32)."""
    k = np.array([0., 5., 5., -1., 3., 3., 2.7, 0., 7.])
    n = np.array([0., 5., 4., 3., 10., 10., 9., 12., 9.])
    p = np.array([0.5, 0.5, 0.5, 0.5, 0.0, 1.0, 0.3, 0.02, 0.999])
    got = S.binom_cdf(torch.from_numpy(k), torch.from_numpy(n),
                      torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, binom.cdf(np.floor(k), n, p), atol=1e-10)
    np.testing.assert_allclose(got, np.asarray(J.binom_cdf(k, n, p)),
                               atol=2e-4)


def test_binom_cdf_matches_jax_below_200():
    rng = np.random.default_rng(0)
    n = rng.integers(1, 200, 3000)
    k = (n * rng.random(3000)).astype(int)
    p = rng.uniform(0.001, 0.999, 3000)
    got = S.binom_cdf(torch.from_numpy(k), torch.from_numpy(n),
                      torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, np.asarray(J.binom_cdf(k, n, p)),
                               rtol=0, atol=2e-4)


def _conflict_inputs(n=4000, seed=7):
    """tests/test_kernels.py:235-244's counts and their scipy p-values."""
    rng = np.random.default_rng(seed)
    cfg_a = rng.integers(0, 40, n).astype(np.float64)
    cfg_b = rng.integers(0, 8, n).astype(np.float64)
    other = rng.integers(0, 6, n).astype(np.float64)
    sup = np.maximum(cfg_a, cfg_b)
    tot = cfg_a + cfg_b + other
    p_exact = binom.cdf(sup, tot, 1 - (6 * NOISE + 10 * NOISE ** 2))
    p_exact = np.where(tot - sup > 0, p_exact, 1.0)
    p_exact = np.where(sup == 0, 0.0, p_exact)
    return cfg_a, cfg_b, other, p_exact


def _thresholds(p_exact):
    """tests/test_kernels.py:246-249: 0.01, 0.2 and a threshold 1e-9 above
    an achievable p-value."""
    return (0.01, 0.2,
            float(np.median(p_exact[(p_exact > 0) & (p_exact < 1)])) + 1e-9)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_prune_mask_matches_scipy_and_jax(which):
    """Every case of tests/test_kernels.py:225-260 on the port: decisions
    equal scipy's wherever the port is sure and, in float64, everywhere;
    pairs within 1e-7 of the threshold are flagged uncertain; outside
    JAX's uncertain band the decisions equal JAX's."""
    cfg_a, cfg_b, other, p_exact = _conflict_inputs()
    thr = _thresholds(p_exact)[which]
    p, prune, uncertain = (x.numpy() for x in S.prune_mask(
        torch.from_numpy(cfg_a), torch.from_numpy(cfg_b),
        torch.from_numpy(other), NOISE, thr))
    np.testing.assert_allclose(p, p_exact, rtol=0, atol=1e-10)
    sure = ~uncertain
    np.testing.assert_array_equal(prune[sure], (p_exact < thr)[sure])
    np.testing.assert_array_equal(prune, p_exact < thr)
    near = np.abs(p_exact - thr) < 1e-7
    assert uncertain[near].all()

    jp, jprune, junc = (np.asarray(x) for x in J.prune_mask(
        jnp.asarray(cfg_a, jnp.float32), jnp.asarray(cfg_b, jnp.float32),
        jnp.asarray(other, jnp.float32), jnp.float32(NOISE), thr))
    np.testing.assert_array_equal(prune[~junc], jprune[~junc])
    np.testing.assert_allclose(p, jp, rtol=0, atol=2e-4)


def test_conflicting_config_p_edge_rules():
    """supporting == 0 gives 0, total == supporting gives 1 (JAX's order:
    a pair with no support at all is 0)."""
    ca = np.array([0, 0, 5, 3, 4, 0])
    cb = np.array([0, 2, 0, 3, 1, 0])
    co = np.array([0, 0, 0, 1, 2, 7])
    got = S.conflicting_config_p(torch.from_numpy(ca), torch.from_numpy(cb),
                                 torch.from_numpy(co), NOISE).numpy()
    want = np.asarray(J.conflicting_config_p(
        jnp.asarray(ca, jnp.float32), jnp.asarray(cb, jnp.float32),
        jnp.asarray(co, jnp.float32), jnp.float32(NOISE)))
    assert got[0] == 0.0 and got[5] == 0.0 and got[2] == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    sup, tot = np.maximum(ca, cb), ca + cb + co
    ref = binom.cdf(sup, tot, 1 - (6 * NOISE + 10 * NOISE ** 2))
    ref = np.where(sup == 0, 0.0, np.where(tot - sup > 0, ref, 1.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_conflict_terms_skip_the_decided_pairs():
    """The operations of the kernel's bound: no term where the edge rules
    decide p, at least one where a fraction is evaluated."""
    ca = torch.tensor([0, 5, 9, 3])
    cb = torch.tensor([0, 0, 2, 3])
    co = torch.tensor([4, 0, 1, 1])
    p, terms = S.conflict_terms(ca, cb, co, NOISE)
    assert terms.tolist()[:2] == [0, 0]
    assert min(terms.tolist()[2:]) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_from_counts_matches_jax(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, (500, 3)).astype(np.int32)
    counts[::3, 2] = rng.integers(0, 3, len(counts[::3]))   # low mismatch
    counts[::7] = 0
    got = S.noise_from_counts(torch.from_numpy(counts))
    assert got.dim() == 0 and got.dtype == torch.float64
    want = float(np.asarray(J.noise_from_counts(jnp.asarray(counts))))
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_cpu_wrappers_do_not_count_launches():
    before = dict(S.LAUNCHES)
    S.binom_cdf(torch.tensor([1.0]), torch.tensor([4.0]), torch.tensor([0.5]))
    S.prune_mask(torch.tensor([3]), torch.tensor([1]), torch.tensor([0]),
                 NOISE, 0.01)
    assert S.LAUNCHES == before


def test_wrappers_refuse_other_devices():
    meta = torch.empty(3, device="meta", dtype=torch.int32)
    with pytest.raises(ValueError):
        S.prune_mask(meta, meta, meta, NOISE, 0.01)
    with pytest.raises(ValueError):
        S.binom_cdf(meta, meta, meta)


def _accuracy_cases(rng, n_max, count=20_000):
    n = rng.integers(1, n_max, count)
    k = (n * rng.random(count)).astype(int)
    return k, n, rng.uniform(0.001, 0.999, count)


def test_jax_float32_error_is_above_its_stated_1e6_and_port_is_not():
    """phaser_tpu/kernels/stats.py:3-6 states its float32 binom_cdf is
    ~1e-6 accurate; on 20,000 random (k, n, p) its max abs error against
    scipy is far above that (but under the 2e-4 its own test allows for
    n < 200), while the port's float64 version stays under 1e-10.  Also
    in the connection test's regime (n < 60, p = 1 - (6e + 10e^2),
    e = 0.0037).  Run with -s to see the errors."""
    rng = np.random.default_rng(20_000)
    cases = {"n < 200": _accuracy_cases(rng, 200),
             "n < 2000": _accuracy_cases(rng, 2000)}
    n = rng.integers(1, 60, 20_000)
    cases["connection test"] = ((n * rng.random(20_000)).astype(int), n,
                                np.full(20_000, 1 - (6 * NOISE +
                                                     10 * NOISE ** 2)))
    errs = {}
    for name, (k, n, p) in cases.items():
        ref = binom.cdf(k, n, p)
        jax_err = float(np.abs(np.asarray(J.binom_cdf(k, n, p)) - ref).max())
        port_err = float(np.abs(S.binom_cdf(
            torch.from_numpy(k), torch.from_numpy(n),
            torch.from_numpy(p)).numpy() - ref).max())
        errs[name] = (jax_err, port_err)
        print("binom_cdf max abs error against scipy, %s: phaser_tpu "
              "float32 %.3g, port float64 %.3g" % (name, jax_err, port_err))
        assert port_err < 1e-10
    assert 1e-6 < errs["n < 200"][0] < 2e-4
    assert errs["n < 2000"][0] > errs["n < 200"][0]
    assert errs["connection test"][0] > 1e-6


@pytest.mark.parametrize("m,seed,thr", [(7120, 1, 0.01), (3000, 2, 0.2),
                                        (500, 3, 1e-4)])
def test_band_prune_plain_is_the_three_call_tail(m, seed, thr):
    """band_prune on CPU tensors (its plain version) equals the three calls
    the step made before it (band_configs, noise_from_counts, the plain
    conflict test) bit for bit, on a band whose tests take fractions."""
    from phaser_tpu_torch.kernels.stats import band_configs
    from phaser_tpu_torch.testing.layouts import band_tail
    counts, pair = (torch.from_numpy(x) for x in band_tail(m, 8, seed))
    got = S.band_prune(counts, pair, thr)
    want = S.conflict_prune_plain(*band_configs(pair),
                                  S.noise_from_counts(counts), thr)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    _, terms = S.conflict_terms(*band_configs(pair),
                                S.noise_from_counts(counts))
    assert int(terms.sum()) > 0 and 0 < int(got[1].sum()) < got[1].numel()


def test_band_prune_refuses_bad_input_and_counts_no_cpu_launch():
    meta = torch.empty((4, 3), device="meta", dtype=torch.int32)
    with pytest.raises(ValueError):
        S.band_prune(meta, meta.view(4, 1, 3), 0.01)
    before = dict(S.LAUNCHES)
    counts = torch.tensor([[5, 4, 0], [3, 3, 1]], dtype=torch.int32)
    pair = torch.zeros((2, 2, 9), dtype=torch.int32)
    pair[0, 0, 0] = 4
    p, prune, unc = S.band_prune(counts, pair, 0.01)
    assert S.LAUNCHES == before
    assert tuple(p.shape) == (2, 2) and p.dtype == torch.float64


def test_binom_cdf_int32_counts_and_0d_p_equal_float64_broadcast():
    """int32 k and n with a 0-d p (conflicting_config_p's operands on the
    card) give the float64 broadcast call's values bit for bit."""
    rng = np.random.default_rng(11)
    n = rng.integers(0, 300, (500, 8)).astype(np.int32)
    k = (n * rng.random(n.shape)).astype(np.int32)
    k[::7] = n[::7]
    p = torch.tensor(1 - (6 * NOISE + 10 * NOISE ** 2), dtype=torch.float64)
    got = S.binom_cdf(torch.from_numpy(k), torch.from_numpy(n), p)
    want = S.binom_cdf(torch.from_numpy(k.astype(np.float64)),
                       torch.from_numpy(n.astype(np.float64)),
                       p.expand(n.shape).contiguous())
    assert got.dtype == torch.float64 and torch.equal(got, want)
    as_float = S.binom_cdf(torch.from_numpy(k), torch.from_numpy(n),
                           float(p))
    assert torch.equal(as_float, want)


@pytest.mark.parametrize("noise", [NOISE, "tensor"])
def test_conflict_operands_equal_conflict_args(noise):
    """What conflicting_config_p's launch reads on the card
    (_conflict_counts: int32 counts, the noise rate one float64 element)
    carries _conflict_args' float64 values exactly: supporting, total and
    p_success formed from them as the kernel forms them equal its own.
    int32 contiguous counts are taken as they are, not copied."""
    cfg_a, cfg_b, other, _ = _conflict_inputs(n=2000, seed=5)
    ca, cb, co = (torch.from_numpy(x.astype(np.int64))
                  for x in (cfg_a, cfg_b, other))
    e = torch.tensor(NOISE, dtype=torch.float64) if noise == "tensor" \
        else noise
    a, b, o, ge = S._conflict_counts(ca, cb, co, e, torch.device("cpu"))
    rs, rt, rp = S._conflict_args(ca, cb, co, e)
    assert a.dtype == b.dtype == o.dtype == torch.int32
    assert a.is_contiguous() and tuple(ge.shape) == (1,)
    assert ge.dtype == torch.float64 and float(ge) == NOISE
    assert torch.equal(torch.maximum(a, b).double(), rs)
    assert torch.equal(a.double() + b.double() + o.double(), rt)
    ee = ge[0]
    assert float(1.0 - (6.0 * ee + 10.0 * (ee * ee))) == float(rp)
    taken = S._conflict_counts(a, b, o, ge, torch.device("cpu"))
    assert [t.data_ptr() for t in taken] == [t.data_ptr()
                                             for t in (a, b, o, ge)]
    with pytest.raises(ValueError, match="integer counts"):
        S._conflict_counts(ca.double(), cb, co, e, torch.device("cpu"))


def test_binom_long_matches_scipy_and_takes_long_fractions():
    """testing/layouts.binom_long (the long-fraction input of the kernel's
    record): the plain version within 1e-10 of scipy, with at least 50
    terms near n = 10,000; band_long's connection tests likewise."""
    from phaser_tpu_torch.testing.layouts import band_long, binom_long
    k, n, p = binom_long(16_384, seed=3)
    args = [torch.from_numpy(x) for x in (k, n, p)]
    np.testing.assert_allclose(S.binom_cdf(*args).numpy(),
                               binom.cdf(k, n, p), rtol=0, atol=1e-10)
    terms = S.binom_cdf_terms(*args).numpy()
    assert terms.min() > 0 and terms[n >= 9000].max() >= 50
    counts, pair = band_long(256, 8, seed=3)
    cfg = S.band_configs(torch.from_numpy(pair))
    noise = S.noise_from_counts(torch.from_numpy(counts))
    p_band, terms = S.conflict_terms(*cfg, noise)
    sup = np.maximum(pair[..., 0], pair[..., 1])
    e = float(noise)
    ref = binom.cdf(sup, pair.sum(-1), 1 - (6 * e + 10 * e * e))
    np.testing.assert_allclose(p_band.numpy(), ref, rtol=0, atol=1e-10)
    assert int(terms.min()) > 0


def _recurrence_betacf(a, b, x):
    """csrc/stats.cu's fraction in float64 torch, element by element as
    the kernel takes it: the three-term recurrence of the convergents
    (A, B), every level multiplied through by its denominators (no
    division), rescaled each term by the power of two of B's exponent, the
    determinant's stop test at half of BETACF_EPS.  Returns (fraction,
    terms)."""
    tiny = S.BETACF_TINY
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    A0, B0 = torch.ones_like(x), torch.ones_like(x)
    A1, B1 = qap.clone(), qap - qab * x
    B1 = torch.where(B1.abs() < tiny * qap, tiny * qap, B1)
    det, dn = qap - B1, qap.clone()
    active = torch.ones(x.shape, dtype=torch.bool)
    terms = torch.zeros(x.shape, dtype=torch.int32)

    def half_step(c1, c2, A0, B0, A1, B1, det):
        A2, B2 = c2 * A0 + c1 * A1, c2 * B0 + c1 * B1
        det = det * -c2
        guard = B2.abs() < tiny * B1.abs()
        B2 = torch.where(guard, tiny * B1, B2)
        det = torch.where(guard, A2 * B1 - A1 * B2, det)
        return A1, B1, A2, B2, det
    for m in range(1, S.BETACF_MAX_ITER + 1):
        if not bool(active.any()):
            break
        m2 = 2.0 * m
        ne, de = m * (b - m) * x, (qam + m2) * (a + m2)
        no = -(a + m) * (qab + m) * x
        dn2 = (a + m2) * (qap + m2)
        nA0, nB0, nA1, nB1, nd = half_step(de, ne * dn, A0, B0, A1, B1, det)
        nA0, nB0, nA1, nB1, nd = half_step(dn2, no * de, nA0, nB0, nA1, nB1,
                                           nd)
        stop = nd.abs() < 0.5 * S.BETACF_EPS * (nB1 * nA0).abs()
        s = torch.where(stop, 1.0, torch.ldexp(
            torch.ones_like(x), 1 - torch.frexp(nB1)[1]))
        A0, B0 = torch.where(active, nA0 * s, A0), torch.where(active,
                                                              nB0 * s, B0)
        A1, B1 = torch.where(active, nA1 * s, A1), torch.where(active,
                                                              nB1 * s, B1)
        det = torch.where(active, nd * s * s, det)
        dn = torch.where(active, dn2, dn)
        terms += active.to(torch.int32)
        active &= ~stop
    return A1 / B1, terms


@pytest.mark.parametrize("case", ["accuracy", "binom_long", "n_100000"])
def test_kernel_recurrence_agrees_with_lentz(case):
    """The card's continued fraction (csrc/stats.cu's division-free
    recurrence, emulated in float64 torch above, one fraction a lane)
    against the plain version's Lentz evaluation: within
    1e-12 as a p-value (the kernel's tolerance against the plain
    version), in at most 5% more terms than Lentz's in all (its stop test
    at half of BETACF_EPS waits a few terms longer where the fraction
    converges slowly, n = 100,000 at the mean).  Run with -s to see the
    gaps."""
    from phaser_tpu_torch.testing.layouts import binom_long
    rng = np.random.default_rng(21)
    if case == "accuracy":
        k, n, p = _accuracy_cases(rng, 5000, 3000)
    elif case == "binom_long":
        k, n, p = binom_long(3000, seed=4)
    else:
        n = np.full(500, 100_000)
        p = rng.uniform(0.001, 0.999, 500)
        k = np.floor(n * p).astype(int)
    k, n, p = (torch.from_numpy(np.asarray(x, np.float64)) for x in (k, n, p))
    a, b = n - k, k + 1.0
    x = 1.0 - p
    lower = x < (a + 1.0) / (a + b + 2.0)
    fa, fb = torch.where(lower, a, b), torch.where(lower, b, a)
    fx = torch.where(lower, x, 1.0 - x)
    lentz, l_terms = S._betacf(fa, fb, fx, torch.ones_like(lower))
    rec, r_terms = _recurrence_betacf(fa, fb, fx)
    front = torch.exp(torch.lgamma(a + b) - torch.lgamma(a) -
                      torch.lgamma(b) + a * torch.log(x) + b * torch.log1p(-x))

    def p_of(cf):
        return torch.where(lower, front * cf / a, 1.0 - front * cf / b)
    gap = float((p_of(rec) - p_of(lentz)).abs().max())
    print("division-free recurrence against Lentz, %s: p %.3g apart, terms "
          "%d against %d" % (case, gap, int(r_terms.sum()),
                             int(l_terms.sum())))
    assert gap < 1e-12, gap
    assert int(r_terms.sum()) <= 1.05 * int(l_terms.sum())
