"""The connection test's statistics on the card (the port of
phaser_tpu/kernels/stats.py), in float64.

binom_cdf matches scipy.stats.binom.cdf (the reference's conflict test,
phaser.py:1649) through the regularized incomplete beta:
    P(X <= k) = I_{1-p}(n-k, k+1)
The JAX package computes it in float32; against scipy its max abs error on
20,000 random (k, n, p) is 6.9e-5 for n < 200 and 7.0e-4 for n < 2,000,
not the 1e-6 its docstring states (tests/test_torch_stats.py measures it).
Here it is float64 throughout, within 1e-10 of scipy for n up to 10,000:
the card's float64 costs nothing at (M, band) sizes.

Where it runs: dist.mesh.sharded_phasing_step, after the shards' counts are
merged: band_prune takes the noise estimate, the banded connection tests and
the pruning on the card in two launches; dist.mesh.connection_p_values
takes the p-values through conflicting_config_p and the binom_cdf kernel.
The engine's host path keeps scipy (variant_connections prints every p at
full precision), as in phaser_tpu.

On CUDA tensors binom_cdf, conflicting_config_p, prune_mask and band_prune
launch the hand kernels of csrc/stats.cu (`binom_cdf_kernel`, which reads
int32 or float64 operands through their strides, a 0-d tensor or a Python
float in place, and for conflicting_config_p reads the three counts and
the noise rate itself and takes the connection test's edge rules: one
launch; the fused `conflict_test_kernel`, which band_prune runs on the
merged band after `noise_partials_kernel`: the step's whole
connection-test tail in two launches).  Both share one incomplete-beta body
(the continued fraction by the three-term recurrence of its convergents,
the prefactor's lgamma from a log-factorial table on the card).  On CPU
tensors they run the plain versions below.  torch has no incomplete beta:
the plain version is the modified Lentz evaluation of the continued
fraction (Numerical Recipes' betacf), vectorized with a convergence mask
per element, with the symmetry switch at x > (a+1)/(a+b+2) and the
prefactor from torch.lgamma; the kernels are held to it at 1e-12.  The
fraction needs O(sqrt(max(a, b))) terms there: at most 110 for n = 10,000
and 237 for n = 100,000 (k at the mean, where it is longest), so
BETACF_MAX_ITER = 1000 holds n up to about 800,000.

`uncertain` marks the pairs whose p lies within `refine_band` of the
threshold, as in phaser_tpu; in float64 their decisions are exact too.
"""

from __future__ import annotations

import ctypes
import numbers
import struct
import threading
from typing import Tuple, Union

import torch

from ..utils import build
from ..utils.counters import bump

BETACF_MAX_ITER = 1000   # csrc/stats.cu kMaxIter
BETACF_EPS = 1e-15       # kEps: a term's factor within this of 1 ends it
BETACF_TINY = 1e-300     # kTiny: Lentz's guard against a zero denominator
# float64 operations of the incomplete beta, the bound's count: what the
# function needs, not what a body spends.  A term is 30 (Lentz's term with
# a division counted as one operation: the fewest of the bodies measured;
# the division-free recurrence the kernels run spends 48, its SASS holding
# 9 DADD, 27 DMUL and 6 DFMA a term), a prefactor 100 (three lgamma, log,
# log1p, exp, the switch)
BETACF_TERM_FLOPS = 30
BETACF_SETUP_FLOPS = 100

# kernel launches per wrapper (CUDA launches only; plain runs do not count);
# "conflict_prune" counts the connection-test kernels: one a prune_mask
# call, two a band_prune call; "lgamma_table" the table's check, once a
# device
LAUNCHES = {"binom_cdf": 0, "conflict_prune": 0, "lgamma_table": 0}
NOISE_PARTIALS = 128     # blocks of band_prune's noise sums, at most
LGAMMA_TABLE_SIZE = 1 << 16   # log-factorials on the card: n + 1 below this
_MAX_DIMS = 6            # csrc/stats.cu kMaxDims: broadcast dimensions


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (float64 torch code)
# ---------------------------------------------------------------------------

def _not_tiny(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() < BETACF_TINY, BETACF_TINY, v)


def _betacf(a, b, x, live) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lentz's continued fraction of I_x(a, b) where `live`; returns the
    fraction and the number of terms each element took (0 where not
    live)."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / _not_tiny(1.0 - qab * x / qap)
    h = d.clone()
    iters = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    active = live.clone()
    for m in range(1, BETACF_MAX_ITER + 1):
        if not bool(active.any()):
            break
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d1 = 1.0 / _not_tiny(1.0 + aa * d)
        c1 = _not_tiny(1.0 + aa / c)
        h1 = h * (d1 * c1)
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d2 = 1.0 / _not_tiny(1.0 + aa * d1)
        c2 = _not_tiny(1.0 + aa / c1)
        delta = d2 * c2
        d = torch.where(active, d2, d)
        c = torch.where(active, c2, c)
        h = torch.where(active, h1 * delta, h)
        iters += active.to(torch.int32)
        active &= (delta - 1.0).abs() >= BETACF_EPS
    return h, iters


def _betainc(a, b, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(I_x(a, b), terms taken) for float64 tensors of one shape, a, b > 0."""
    inside = (x > 0.0) & (x < 1.0)
    xs = torch.where(inside, x, 0.5)
    front = torch.exp(torch.lgamma(a + b) - torch.lgamma(a) -
                      torch.lgamma(b) + a * torch.log(xs) +
                      b * torch.log1p(-xs))
    lower = xs < (a + 1.0) / (a + b + 2.0)
    # one fraction per element: (a, b, x) below the switch, else (b, a, 1-x)
    fa = torch.where(lower, a, b)
    fb = torch.where(lower, b, a)
    fx = torch.where(lower, xs, 1.0 - xs)
    cf, iters = _betacf(fa, fb, fx, inside)
    val = torch.where(lower, front * cf / a, 1.0 - front * cf / b)
    val = torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, val))
    return val, iters


def _binom_terms(k, n, p) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cdf, terms taken), float64, for broadcastable k, n, p."""
    # a Python float stays float64 (torch.as_tensor alone makes float32)
    k, n, p = torch.broadcast_tensors(*(
        t.to(torch.float64) if isinstance(t, torch.Tensor)
        else torch.as_tensor(t, dtype=torch.float64) for t in (k, n, p)))
    kk = torch.floor(k)
    full = kk >= n
    neg = kk < 0
    a = torch.clamp_min(n - kk, 1e-30)
    x = torch.clamp(1.0 - p, 0.0, 1.0)
    val, iters = _betainc(a, kk + 1.0, torch.where(full | neg, 0.0, x))
    val = torch.where(full, 1.0, torch.where(neg, 0.0, val))
    return val, iters


def binom_cdf_plain(k, n, p) -> torch.Tensor:
    return _binom_terms(k, n, p)[0]


def _conflict_args(config_a, config_b, other, noise_e):
    """(supporting, total, p_success) in float64 (stats.py:50-52)."""
    ca, cb, co = (torch.as_tensor(t).to(torch.float64)
                  for t in (config_a, config_b, other))
    e = torch.as_tensor(noise_e, dtype=torch.float64, device=ca.device)
    sup = torch.maximum(ca, cb)
    total = ca + cb + co
    return sup, total, 1.0 - (6.0 * e + 10.0 * (e * e))


def conflict_terms(config_a, config_b, other, noise_e
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, terms taken) of the plain conflict test; the terms are 0 where
    the edge rules decide p, as in the kernel."""
    sup, total, p_success = _conflict_args(config_a, config_b, other,
                                           noise_e)
    decided = (sup == 0) | ~(total - sup > 0)
    p, iters = _binom_terms(torch.where(decided, -1.0, sup), total,
                            p_success.expand_as(sup))
    p = torch.where(total - sup > 0, p, 1.0)
    p = torch.where(sup == 0, 0.0, p)
    return p, iters


def conflict_prune_plain(config_a, config_b, other, noise_e,
                         threshold: float, refine_band: float = 1e-3):
    p = conflict_terms(config_a, config_b, other, noise_e)[0]
    return p, p < threshold, (p - threshold).abs() < refine_band


def band_configs(pair: torch.Tensor):
    """(cis, trans, other) support of every pair of the merged (M, band, 9)
    band: configurations 0+4, 1+3 and the other five (phaser_tpu
    dist/mesh.py:111-114; band_prune's test body forms the same sums)."""
    cfg_a = pair[:, :, 0] + pair[:, :, 4]
    cfg_b = pair[:, :, 1] + pair[:, :, 3]
    other = (pair[:, :, 2] + pair[:, :, 5] + pair[:, :, 6] +
             pair[:, :, 7] + pair[:, :, 8])
    return cfg_a, cfg_b, other


def band_prune_plain(counts, pair, threshold: float,
                     refine_band: float = 1e-3):
    """The step's connection-test tail as three calls: the cis / trans /
    other support of the band, the noise rate of the counts, the test."""
    return conflict_prune_plain(*band_configs(pair), noise_from_counts(counts),
                                threshold, refine_band)


def binom_cdf_terms(k, n, p) -> torch.Tensor:
    """Continued-fraction terms binom_cdf takes per element (the
    operations of the kernel's bound)."""
    return _binom_terms(k, n, p)[1]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_tables = {}             # device index -> (table, mismatches)
_tables_lock = threading.Lock()


def _on_cuda(dev: torch.device) -> bool:
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError("stats kernels take CPU or CUDA tensors, not %s" % dev)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def lgamma_table(dev: torch.device) -> torch.Tensor:
    """The log-factorial table the kernels' prefactor reads: float64
    lgamma(i), 0 <= i < LGAMMA_TABLE_SIZE, on the card `dev`.  Built once a
    device by torch.lgamma; lgamma_table_kernel then makes every entry equal
    to the kernels' own lgamma (counting the entries it replaced:
    lgamma_table_mismatches), so the table changes no bit of the prefactor.
    The stream is synchronized once, after the build, for callers on other
    streams."""
    key = _device_index(dev)
    with _tables_lock:
        if key not in _tables:
            d = torch.device("cuda", key)
            table = torch.arange(LGAMMA_TABLE_SIZE, dtype=torch.float64,
                                 device=d).lgamma_()
            mismatches = torch.zeros(1, dtype=torch.int32, device=d)
            build.launch("lgamma_table_launch", [_P, _I, _P, _P],
                         (table.data_ptr(), LGAMMA_TABLE_SIZE,
                          mismatches.data_ptr(), _stream(d)))
            bump(LAUNCHES, "lgamma_table")
            torch.cuda.current_stream(d).synchronize()
            _tables[key] = (table, mismatches)
        return _tables[key][0]


def lgamma_table_mismatches(dev: torch.device) -> int:
    """Entries of the device's table where torch.lgamma and the kernels'
    lgamma differed (a read of the card)."""
    lgamma_table(dev)
    return int(_tables[_device_index(dev)][1].item())


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _operand(t, shape, dev):
    """(binom_cdf's descriptor words of one operand, the tensor they point
    into: kept alive until the launch is enqueued) (csrc/stats.cu
    operand_of): kind (0 a value, 1 one element on the card, 2 the full
    shape contiguous, 3 a view through its strides), type (0 float64, 1
    int32), pointer, the value's bits, strides.  int32 and float64 tensors
    are read in place; other types are converted to float64 first."""
    if not isinstance(t, torch.Tensor):
        bits = struct.unpack("<q", struct.pack("<d", float(t)))[0]
        return [0, 0, 0, bits] + [0] * _MAX_DIMS, None
    if t.device != dev:
        raise ValueError("binom_cdf operands must all lie on %s, not %s"
                         % (dev, t.device))
    if t.dtype not in (torch.int32, torch.float64):
        t = t.to(torch.float64)
    typ = 1 if t.dtype == torch.int32 else 0
    if t.numel() == 1:
        return [1, typ, t.data_ptr(), 0] + [0] * _MAX_DIMS, t
    if t.shape == shape and t.is_contiguous():
        return [2, typ, t.data_ptr(), 0] + [0] * _MAX_DIMS, t
    v = t.expand(shape)
    strides = list(v.stride()) + [0] * (_MAX_DIMS - v.dim())
    return [3, typ, v.data_ptr(), 0] + strides, t


def _broadcast_shape(shapes) -> tuple:
    """torch.broadcast_shapes of a few shapes (which costs tens of
    microseconds a call)."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, d in enumerate(s, nd - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError("shapes %s do not broadcast"
                                     % (list(shapes),))
                out[i] = d
    return tuple(out)


BINOM_ARGTYPES = [_P, _I, _P, _I, _P, _P]   # binom_cdf_launch's
# binom_cdf_launch's descriptor: ndim, the sizes, then k, n and p's words
_Desc = ctypes.c_longlong * (1 + _MAX_DIMS + 3 * (4 + _MAX_DIMS))


def binom_launch_args(k, n, p, dev: torch.device):
    """(binom_cdf_launch's arguments, the output, what they point into)
    for one launch over the broadcast shape of k, n and p.  The last two
    must stay alive until the launch is enqueued."""
    ops = [t if isinstance(t, (torch.Tensor, numbers.Real))
           else torch.as_tensor(t, device=dev) for t in (k, n, p)]
    shape = _broadcast_shape([tuple(t.shape) for t in ops
                              if isinstance(t, torch.Tensor)] or [()])
    if len(shape) > _MAX_DIMS:
        raise ValueError("binom_cdf takes at most %d dimensions, not %d"
                         % (_MAX_DIMS, len(shape)))
    table = lgamma_table(dev)
    out = torch.empty(shape, dtype=torch.float64, device=dev)
    dev = out.device                      # "cuda" -> "cuda:0"
    if out.numel() >= (1 << 31):
        raise ValueError("binom_cdf of %d elements exceeds int32 indexing"
                         % out.numel())
    words = [len(shape)] + list(shape) + [1] * (_MAX_DIMS - len(shape))
    keep = [table]
    for t in ops:
        w, held = _operand(t, shape, dev)
        words += w
        keep.append(held)
    desc = _Desc(*words)
    keep.append(desc)
    args = (ctypes.addressof(desc), out.numel(), table.data_ptr(),
            table.numel(), out.data_ptr(), _stream(dev))
    return args, out, keep


def _device_of(*ts) -> torch.device:
    return next((t.device for t in ts if isinstance(t, torch.Tensor)),
                torch.device("cpu"))


def binom_cdf(k, n, p) -> torch.Tensor:
    """P(X <= k) for X ~ Binomial(n, p), elementwise over broadcastable k,
    n, p, in float64 (phaser_tpu kernels/stats.py:32-43).  On CUDA tensors
    the binom_cdf kernel: k and n int32 or float64 (other types converted
    to float64), p a tensor, a 0-d tensor or a Python float, each read in
    place through its strides (nothing broadcast or copied)."""
    dev = _device_of(k, n, p)
    if not _on_cuda(dev):
        return binom_cdf_plain(k, n, p)
    args, out, keep = binom_launch_args(k, n, p, dev)
    if out.numel():
        build.launch("binom_cdf_launch", BINOM_ARGTYPES, args)
        bump(LAUNCHES, "binom_cdf")
    return out


def _conflict_counts(config_a, config_b, other, noise_e, dev):
    """(cis, trans, other, noise) as conflicting_config_p's launch reads
    them on `dev`: the counts as contiguous int32 tensors of their
    broadcast shape (int32 contiguous counts of that shape are taken as
    they are; other integer types are converted, exactly, since they are
    counts), the noise rate one float64 element (noise_from_counts gives
    it there: no copy and no sync).  Floating-point counts raise."""
    ts = [torch.as_tensor(t, device=dev) for t in (config_a, config_b, other)]
    if any(t.is_floating_point() or t.is_complex() for t in ts):
        raise ValueError("conflicting_config_p on the card takes integer "
                         "counts, not %s" % [t.dtype for t in ts])
    shape = _broadcast_shape([tuple(t.shape) for t in ts])
    ca, cb, co = (t.to(torch.int32).expand(shape).contiguous() for t in ts)
    if isinstance(noise_e, torch.Tensor):
        e = noise_e.to(device=dev, dtype=torch.float64).reshape(1)
    else:
        e = torch.tensor([float(noise_e)], dtype=torch.float64, device=dev)
    return ca, cb, co, e


def conflicting_config_p(config_a, config_b, other, noise_e) -> torch.Tensor:
    """The connection test's p-value, float64 (phaser_tpu
    kernels/stats.py:46-56, the reference's test_variant_connection): the
    binomial cdf of the supporting count, then the edge rules (total -
    supporting <= 0 gives 1, supporting == 0 gives 0).  On CUDA tensors
    one binom_cdf_kernel launch that reads the integer counts and the
    noise rate where they lie (_conflict_counts) and forms supporting,
    total and p_success itself; prune_mask computes the same p fused with
    the decisions."""
    dev = _device_of(config_a, config_b, other)
    if not _on_cuda(dev):
        sup, total, p_success = _conflict_args(config_a, config_b, other,
                                               noise_e)
        p = binom_cdf(sup, total, p_success)
        p = torch.where(total - sup > 0, p, 1.0)
        return torch.where(sup == 0, 0.0, p)
    ca, cb, co, e = _conflict_counts(config_a, config_b, other, noise_e, dev)
    if ca.numel() >= (1 << 31):
        raise ValueError("%d pairs exceed int32 indexing" % ca.numel())
    table = lgamma_table(dev)
    out = torch.empty(ca.shape, dtype=torch.float64, device=dev)
    if out.numel():
        build.launch("conflict_p_launch", [_P] * 4 + [_I, _P, _I, _P, _P],
                     (ca.data_ptr(), cb.data_ptr(), co.data_ptr(),
                      e.data_ptr(), out.numel(), table.data_ptr(),
                      table.numel(), out.data_ptr(), _stream(dev)))
        bump(LAUNCHES, "binom_cdf")
    return out


def prune_mask(config_a: torch.Tensor, config_b: torch.Tensor,
               other: torch.Tensor, noise_e: Union[torch.Tensor, float],
               threshold: float, refine_band: float = 1e-3):
    """On-card connection pruning (phaser_tpu kernels/stats.py:59-72,
    phaser.py:696-707).  Returns (p float64, prune = p < threshold,
    uncertain = |p - threshold| < refine_band).

    On CUDA tensors the fused conflict test (band_prune's test body, on
    three arrays): the three counts must be int32 tensors of one shape, and
    noise_e a float64 tensor of one element on the same card
    (noise_from_counts gives it there, so the host never waits for it).  On
    CPU tensors any numeric types."""
    dev = config_a.device
    if not _on_cuda(dev):
        return conflict_prune_plain(config_a, config_b, other, noise_e,
                                    threshold, refine_band)
    shape = tuple(config_a.shape)
    for name, t in (("config_a", config_a), ("config_b", config_b),
                    ("other", other)):
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != shape:
            raise ValueError("%s must be an int32 tensor of shape %s on %s, "
                             "not %s %s on %s" % (name, shape, dev, t.dtype,
                                                  tuple(t.shape), t.device))
    if not isinstance(noise_e, torch.Tensor):
        noise_e = torch.tensor(float(noise_e), dtype=torch.float64,
                               device=dev)
    if noise_e.device != dev or noise_e.dtype != torch.float64 or \
            noise_e.numel() != 1:
        raise ValueError("noise_e must be one float64 element on %s" % dev)
    a, b, o = (t.contiguous() for t in (config_a, config_b, other))
    count = a.numel()
    if count >= (1 << 31):
        raise ValueError("%d pairs exceed int32 indexing" % count)
    table = lgamma_table(dev)
    p = torch.empty(shape, dtype=torch.float64, device=dev)
    prune = torch.empty(shape, dtype=torch.bool, device=dev)
    uncertain = torch.empty(shape, dtype=torch.bool, device=dev)
    build.launch("conflict_prune_launch",
                 [_P] * 4 + [_D, _D, _I, _P, _I] + [_P] * 4,
                 (a.data_ptr(), b.data_ptr(), o.data_ptr(),
                  noise_e.contiguous().data_ptr(), float(threshold),
                  float(refine_band), count, table.data_ptr(),
                  table.numel(), p.data_ptr(), prune.data_ptr(),
                  uncertain.data_ptr(), _stream(dev)))
    bump(LAUNCHES, "conflict_prune")
    return p, prune, uncertain


def band_prune(counts: torch.Tensor, pair: torch.Tensor, threshold: float,
               refine_band: float = 1e-3):
    """The sharded step's connection-test tail from the merged (M, 3) int32
    counts and (M, band, 9) int32 band: (p float64, prune = p < threshold,
    uncertain = |p - threshold| < refine_band), each (M, band), as
    prune_mask(*band_configs(pair), noise_from_counts(counts), threshold)
    gives them.  On CUDA tensors two launches (the noise rate's int64 sums,
    then the test of every (v, d) on the band's 9 words); on CPU tensors
    band_prune_plain."""
    dev = counts.device
    if not _on_cuda(dev):
        return band_prune_plain(counts, pair, threshold, refine_band)
    M = counts.shape[0]
    if tuple(counts.shape) != (M, 3) or pair.dim() != 3 or \
            pair.shape[0] != M or pair.shape[2] != 9:
        raise ValueError("counts %s and pair %s must be (M, 3) and (M, band, "
                         "9)" % (tuple(counts.shape), tuple(pair.shape)))
    for name, t in (("counts", counts), ("pair", pair)):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError("%s must be int32 on %s, not %s on %s"
                             % (name, dev, t.dtype, t.device))
    band = pair.shape[1]
    if M * band * 9 >= (1 << 31):
        raise ValueError("a band of %d x %d exceeds int32 indexing"
                         % (M, band))
    c, b = counts.contiguous(), pair.contiguous()
    table = lgamma_table(dev)
    partials = torch.empty(2 * NOISE_PARTIALS, dtype=torch.int64, device=dev)
    p = torch.empty((M, band), dtype=torch.float64, device=dev)
    prune = torch.empty((M, band), dtype=torch.bool, device=dev)
    uncertain = torch.empty((M, band), dtype=torch.bool, device=dev)
    launches = ctypes.c_int(0)
    build.launch("band_prune_launch",
                 [_P, _P, _I, _I, _D, _D, _P, _I, _P, _I] + [_P] * 5,
                 (c.data_ptr(), b.data_ptr(), M, band, float(threshold),
                  float(refine_band), partials.data_ptr(), NOISE_PARTIALS,
                  table.data_ptr(), table.numel(), p.data_ptr(),
                  prune.data_ptr(), uncertain.data_ptr(),
                  ctypes.addressof(launches), _stream(dev)))
    if launches.value:
        bump(LAUNCHES, "conflict_prune", launches.value)
    return p, prune, uncertain


def noise_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Global sequencing-noise estimate from merged (M, 3) allele-class
    counts (phaser_tpu kernels/stats.py:75-86, phaser.py:610-632):
    variants under 5% mismatch contribute; noise_e = mismatches /
    (2 * (matches + mismatches)).  A float64 0-d tensor on counts' device;
    nothing is fetched to the host."""
    c = counts.to(torch.float64)
    matches = c[:, 0] + c[:, 1]
    mis = c[:, 2]
    tot = torch.clamp_min(matches + mis, 1.0)
    use = (matches > 0) & (mis / tot < 0.05)
    bm = torch.where(use, matches, 0.0).sum()
    bmm = torch.where(use, mis, 0.0).sum()
    return bmm / torch.clamp_min((bm + bmm) * 2.0, 1.0)
