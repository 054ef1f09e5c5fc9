"""Bootstrap medians for phASER-POP cis-var, as torch code on a device
(the port of phaser_tpu/kernels/bootstrap.py).

The reference draws 4 x 10,000 index resamples per (gene, variant) pair
serially with numpy and medians each resample (reference
phaser_pop/phaser_cis_var.py:202-219).  Here, as in phaser_tpu, the
bootstrap median's ORDER STATISTICS are sampled in closed form, which is
distribution-exact and moves no per-draw data:

  * a bootstrap resample draws n iid indices uniform on {0..n-1}, i.e.
    floor(n * U) with U ~ Uniform(0,1); floor is monotone, so the k-th order
    statistic of the indices is floor(n * U_(k));
  * U_(k) ~ Beta(k+1, n-k), sampled as Ga / (Ga + Gb) from two standard
    gammas (a, b >= 1, so the ratio is well conditioned in float32);
  * the median needs the two middle order statistics k1=(n-1)//2, k2=n//2 of
    the SAME draw: conditional on U_(k1)=x, U_(k2) is the minimum of the
    remaining n-k1-1 uniforms above x: x + (1-x) * (1 - (1-u)^(1/(n-k1-1)));
  * each cohort is sorted ONCE (padded with +inf); every draw is then two
    gathers.

Per cohort the result is the 2.5 / 97.5 percentiles of the bs medians
(linear interpolation, as jnp.percentile) and the two-sided sign test
2 * min(#>0, #<0) / bs; empty cohorts give nan.  All arithmetic is float32.

Random numbers come from one torch.Generator per call, seeded with `seed`,
on the device of the work.  Rows are cut into chunks by a fixed memory
budget computed from (rows, cohort width, bs) only, never from the free
memory of the device, and the chunks draw from the generator in turn.  The
contract is determinism per (seed, bs, cohort set, device): the CPU and
CUDA generators give different streams, and neither is phaser_tpu's JAX
PRNG, so the CI bounds are statistically equal to phaser_tpu's, not
bitwise equal.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..utils.trace import DeviceClock

# bytes one chunk of rows may hold on the device: per row and draw about
# 14 float32-sized temporaries (two gamma samples, their concentrations,
# x, u, y, two int64 indices, two gathered values, the medians, the sort
# inside torch.quantile) and the padded cohort
CHUNK_BYTES = 2 << 30
_BYTES_PER_DRAW = 4 * 16
# torch.quantile sorts at most 2^24 elements per call
_QUANTILE_MAX = 1 << 24

# calls of bootstrap_cis_device, the non-empty cohorts (rows) and chunks
# they ran, and the device seconds of their uploads, chunks and fetches
# (utils/trace.DeviceClock: CUDA events on the card, the host clock on the
# CPU)
STATS = {"calls": 0, "rows": 0, "chunks": 0, "device_s": 0.0}


def rows_per_chunk(n_pad: int, bs: int, budget: int) -> int:
    """Rows of one chunk: a function of the cohort width, bs and the
    budget only, so a seed gives the same draws on any free memory."""
    per_row = bs * _BYTES_PER_DRAW + n_pad * 4
    rows = min(budget // per_row, _QUANTILE_MAX // bs)
    if rows < 1:
        raise ValueError("bs %d with cohorts of %d does not fit one row of "
                         "the chunk budget" % (bs, n_pad))
    return int(rows)


def bootstrap_medians(xs_sorted: torch.Tensor, n: torch.Tensor, bs: int,
                      g: torch.Generator) -> torch.Tensor:
    """(B, bs) float32 bootstrap medians by order-statistic inversion.

    xs_sorted: (B, Npad) float32, each row ascending with +inf padding;
    n: (B,) int64 cohort sizes >= 1 (phaser_tpu kernels/bootstrap.py:38-60).
    """
    B = xs_sorted.shape[0]
    dev = xs_sorted.device
    k1 = (n - 1) // 2
    k2 = n // 2
    a = (k1 + 1).to(torch.float32)[:, None].expand(B, bs).contiguous()
    b = (n - k1).to(torch.float32)[:, None].expand(B, bs).contiguous()
    ga = torch._standard_gamma(a, generator=g)
    gb = torch._standard_gamma(b, generator=g)
    del a, b
    x = ga / (ga + gb)
    del ga, gb
    u = torch.rand((B, bs), generator=g, device=dev, dtype=torch.float32)
    m = torch.clamp((n - k1 - 1).to(torch.float32), min=1.0)[:, None]
    y = x + (1.0 - x) * (1.0 - (1.0 - u) ** (1.0 / m))
    del u
    y = torch.where((k2 > k1)[:, None], y, x)
    nf = n.to(torch.float32)[:, None]
    hi = (n - 1)[:, None]
    # x can round to 1.0 in float32: trunc(x * n) == n, hence the clamp
    i1 = torch.minimum((x * nf).to(torch.int64).clamp_(min=0), hi)
    i2 = torch.minimum((y * nf).to(torch.int64).clamp_(min=0), hi)
    del x, y
    v1 = torch.gather(xs_sorted, 1, i1)
    v2 = torch.gather(xs_sorted, 1, i2)
    return 0.5 * (v1 + v2)


def median_tails(meds: torch.Tensor, bs: int) -> torch.Tensor:
    """(3, B) float32 [lower; upper; p]: the 2.5 / 97.5 percentiles of each
    row's medians and 2 * min(#>0, #<0) / bs (phaser_tpu
    kernels/bootstrap.py:63-73)."""
    q = torch.tensor([0.025, 0.975], dtype=torch.float32, device=meds.device)
    lo_hi = torch.quantile(meds, q, dim=1)
    pos = (meds > 0).sum(dim=1)
    neg = (meds < 0).sum(dim=1)
    p = torch.minimum(pos, neg).to(torch.float32) / bs * 2.0
    return torch.cat([lo_hi, p[None]], dim=0)


def check_device(device) -> torch.device:
    """torch.device for "cuda" or "cpu"; raises RuntimeError when the card
    is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r needs a CUDA GPU, but torch.cuda.is_available() is "
            "False (use --device cpu)" % str(device))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % str(device))
    return dev


def bootstrap_cis_device(cohorts: List[np.ndarray], bs: int, seed: int = 0,
                         device="cuda") -> List[Tuple[float, float, float]]:
    """(lower, upper, p) per cohort from `bs` bootstrap medians each, all
    cohorts batched on `device` in chunks of CHUNK_BYTES; empty cohorts
    give nans.  Deterministic per (seed, bs, cohort set, device)."""
    dev = check_device(device)
    STATS["calls"] += 1
    out: List[Tuple[float, float, float]] = [None] * len(cohorts)
    idxs = [i for i, c in enumerate(cohorts) if len(c)]
    nan = float("nan")
    for i, c in enumerate(cohorts):
        if not len(c):
            out[i] = (nan, nan, nan)
    if not idxs:
        return out
    STATS["rows"] += len(idxs)
    ns = np.array([len(cohorts[i]) for i in idxs], np.int64)
    n_pad = int(ns.max())
    X = np.full((len(idxs), n_pad), np.inf, np.float32)
    for k, i in enumerate(idxs):
        X[k, :ns[k]] = np.sort(np.asarray(cohorts[i], np.float64))
    rows = rows_per_chunk(n_pad, bs, CHUNK_BYTES)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    clock = DeviceClock(dev)
    with clock.span():
        X_dev = torch.from_numpy(X).to(dev)
        n_dev = torch.from_numpy(ns).to(dev)
        parts = []
        for c0 in range(0, len(idxs), rows):
            meds = bootstrap_medians(X_dev[c0:c0 + rows],
                                     n_dev[c0:c0 + rows], bs, g)
            parts.append(median_tails(meds, bs))
            STATS["chunks"] += 1
            del meds
        res = torch.cat(parts, dim=1).cpu()
    STATS["device_s"] += clock.collect()
    lo, hi, p = res.numpy()
    for k, i in enumerate(idxs):
        out[i] = (float(lo[k]), float(hi[k]), float(p[k]))
    return out
