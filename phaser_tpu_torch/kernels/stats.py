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
merged: the noise estimate, the banded connection tests and the pruning
stay on the card.  The engine's host path keeps scipy (variant_connections
prints every p at full precision), as in phaser_tpu.

On CUDA tensors binom_cdf and prune_mask launch the hand kernels of
csrc/stats.cu (`binom_cdf_kernel`, the fused `conflict_prune_kernel`); on
CPU tensors they run the plain versions below, which carry out the same
recurrence with the same constants.  torch has no incomplete beta: the
plain version is the modified Lentz evaluation of the continued fraction
(Numerical Recipes' betacf), vectorized with a convergence mask per
element, with the symmetry switch at x > (a+1)/(a+b+2) and the prefactor
from torch.lgamma.  The fraction needs O(sqrt(max(a, b))) terms there:
at most 110 for n = 10,000 and 237 for n = 100,000 (k at the mean, where
it is longest), so BETACF_MAX_ITER = 1000 holds n up to about 800,000.

`uncertain` marks the pairs whose p lies within `refine_band` of the
threshold, as in phaser_tpu; in float64 their decisions are exact too.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from ..utils import build
from ..utils.counters import bump

BETACF_MAX_ITER = 1000   # csrc/stats.cu kMaxIter
BETACF_EPS = 1e-15       # kEps: a term's factor within this of 1 ends it
BETACF_TINY = 1e-300     # kTiny: Lentz's guard against a zero denominator

# kernel launches per wrapper (CUDA launches only; plain runs do not count)
LAUNCHES = {"binom_cdf": 0, "conflict_prune": 0}


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
    k, n, p = torch.broadcast_tensors(*(torch.as_tensor(t).to(torch.float64)
                                        for t in (k, n, p)))
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


def _on_cuda(dev: torch.device) -> bool:
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError("stats kernels take CPU or CUDA tensors, not %s" % dev)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def binom_cdf(k, n, p) -> torch.Tensor:
    """P(X <= k) for X ~ Binomial(n, p), elementwise over broadcastable k,
    n, p, in float64 (phaser_tpu kernels/stats.py:32-43).  On CUDA tensors
    the binom_cdf kernel."""
    dev = next((t.device for t in (k, n, p) if isinstance(t, torch.Tensor)),
               torch.device("cpu"))
    if not _on_cuda(dev):
        return binom_cdf_plain(k, n, p)
    k, n, p = (t.contiguous() for t in torch.broadcast_tensors(
        *(torch.as_tensor(t, device=dev).to(torch.float64)
          for t in (k, n, p))))
    out = torch.empty_like(k)
    if out.numel() >= (1 << 31):
        raise ValueError("binom_cdf of %d elements exceeds int32 indexing"
                         % out.numel())
    build.launch("binom_cdf_launch", [_P] * 3 + [_I, _P, _P],
                 (k.data_ptr(), n.data_ptr(), p.data_ptr(), out.numel(),
                  out.data_ptr(), _stream(dev)))
    bump(LAUNCHES, "binom_cdf")
    return out


def conflicting_config_p(config_a, config_b, other, noise_e) -> torch.Tensor:
    """The connection test's p-value, float64 (phaser_tpu
    kernels/stats.py:46-56, the reference's test_variant_connection): the
    binomial cdf of the supporting count (on CUDA tensors the binom_cdf
    kernel), then the edge rules.  prune_mask computes the same p fused
    with the decisions."""
    sup, total, p_success = _conflict_args(config_a, config_b, other,
                                           noise_e)
    p = binom_cdf(sup, total, p_success)
    p = torch.where(total - sup > 0, p, 1.0)
    return torch.where(sup == 0, 0.0, p)


def prune_mask(config_a: torch.Tensor, config_b: torch.Tensor,
               other: torch.Tensor, noise_e: Union[torch.Tensor, float],
               threshold: float, refine_band: float = 1e-3):
    """On-card connection pruning (phaser_tpu kernels/stats.py:59-72,
    phaser.py:696-707).  Returns (p float64, prune = p < threshold,
    uncertain = |p - threshold| < refine_band).

    On CUDA tensors the fused conflict_prune kernel: the three counts must
    be int32 tensors of one shape, and noise_e a float64 tensor of one
    element on the same card (noise_from_counts gives it there, so the
    host never waits for it).  On CPU tensors any numeric types."""
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
    p = torch.empty(shape, dtype=torch.float64, device=dev)
    prune = torch.empty(shape, dtype=torch.bool, device=dev)
    uncertain = torch.empty(shape, dtype=torch.bool, device=dev)
    build.launch("conflict_prune_launch",
                 [_P] * 4 + [_D, _D, _I] + [_P] * 4,
                 (a.data_ptr(), b.data_ptr(), o.data_ptr(),
                  noise_e.contiguous().data_ptr(), float(threshold),
                  float(refine_band), count, p.data_ptr(), prune.data_ptr(),
                  uncertain.data_ptr(), _stream(dev)))
    bump(LAUNCHES, "conflict_prune")
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
