"""Block phasing (the port of phaser_tpu/engine/phasing.py).

`sub_block_phase` and `phase_v3` are copies with a `device` argument: on a
non-host device a full enumeration of at least DEVICE_SCORE_GATE variants
is scored by this package's torch scorer (kernels.phasescore), or the call
raises; otherwise the host enumeration scores it.  Both scores are exact
integers, so the outputs are the same either way.  Unlike phaser_tpu, whose
scorer runs whatever --device says (engine/phasing.py:152), the port gates
on the device.  The helpers are imported unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from phaser_tpu.engine.phasing import (AlleleConn, _enumerate_phase_host,
                                       _score_configs, inverse_config,
                                       resolve_phase, split_by_weak)

from ..utils.counters import bump

# sub-blocks of at least this many variants are scored on the device
# (phaser_tpu engine/phasing.py:152)
DEVICE_SCORE_GATE = 16
# device calls
COUNTS = {"device_calls": 0}


def _device_full_enumeration(variants: Sequence[int], ac: AlleleConn,
                             n: int, device) -> List[str]:
    """Full 2^(n-1) enumeration scored on `device`; same result contract as
    the host path: a unique best -> [config, inverse], a tie -> the "-"
    sentinel (phaser_tpu engine/phasing.py:109-132)."""
    import torch

    from ..kernels.phasescore import enumerate_scores
    from ..mapper.dispatch import resolve_device

    dev = resolve_device(device)
    bump(COUNTS, "device_calls")
    local = {v: i for i, v in enumerate(variants)}
    M = np.zeros((2 * n, 2 * n), np.float32)
    for i, v in enumerate(variants):
        for a in (0, 1):
            for (w, b) in ac.get((v, a), ()):
                j = local.get(w)
                if j is not None and w != v:
                    M[i * 2 + a, j * 2 + b] = 1.0
    scores = enumerate_scores(torch.from_numpy(M).to(dev), n)
    # the first two configs of maximal score: one means a unique best
    best = torch.nonzero(scores == scores.max()).flatten()[:2].cpu()
    if len(best) == 1:
        bits = int(best[0])
        cfg = "0" + format(bits, "0%db" % (n - 1)) if n > 1 else "0"
        return [cfg, inverse_config(cfg)]
    return ["-" * n, "-" * n]


def sub_block_phase(variants: Sequence[int], ac: AlleleConn,
                    sub_block_configs: Optional[List[List[str]]] = None,
                    attempt_resolve: bool = False,
                    device: str = "host") -> List[str]:
    """sub_block_phase (:2209-2258; phaser_tpu engine/phasing.py:135-183)."""
    if sub_block_configs:
        configurations = [
            sub_block_configs[0][0] + sub_block_configs[1][0],
            sub_block_configs[0][0] + sub_block_configs[1][1],
            sub_block_configs[0][1] + sub_block_configs[1][0],
            sub_block_configs[0][1] + sub_block_configs[1][1],
        ]
    else:
        if attempt_resolve:
            xhap = resolve_phase(variants, ac, clean_connections=True)
            if xhap is not None:
                return xhap[0]
        n = len(variants)
        if n >= DEVICE_SCORE_GATE and device not in ("host", "off"):
            from phaser_tpu.utils.trace import device_section
            with device_section():
                return _device_full_enumeration(variants, ac, n, device)
        # itertools.product("01", repeat=n) order, one per complement
        # class: exactly the configs starting with '0', scored as bit
        # patterns without materializing 2^(n-1) strings.
        return _enumerate_phase_host(variants, ac, n)

    # complement-class dedup in iteration order
    seen = set()
    uniq_configs: List[str] = []
    for cfg in configurations:
        inv = inverse_config(cfg)
        if (cfg + "|" + inv) in seen or (inv + "|" + cfg) in seen:
            continue
        seen.add(cfg + "|" + inv)
        uniq_configs.append(cfg)

    scores = _score_configs(variants, ac, uniq_configs)
    max_support = int(scores.max())
    best = [uniq_configs[i] for i in np.flatnonzero(scores == max_support)]
    if len(best) == 1:
        return [best[0], inverse_config(best[0])]
    return ["-" * len(variants), "-" * len(variants)]


def phase_v3(variants: Sequence[int],
             variant_connections: Dict[int, Set[int]],
             ac: AlleleConn, max_block_size: int,
             device: str = "host") -> List[List[Tuple[int, str]]]:
    """phase_v3 (:2107-2170; phaser_tpu engine/phasing.py:289-332).
    Returns phased blocks as lists of (table_index, allele_char) tuples;
    sentinel blocks dropped."""
    xhap = resolve_phase(variants, ac)
    if xhap is not None:
        final_blocks = xhap
    else:
        xmax = len(variants) if max_block_size == 0 else max_block_size
        sub_blocks = split_by_weak(variants, variant_connections, xmax)
        if len(sub_blocks) == 1:
            sub_block_phases = [sub_block_phase(xv, ac, device=device)
                                for xv in sub_blocks]
        else:
            sub_block_phases = [sub_block_phase(xv, ac, attempt_resolve=True,
                                                device=device)
                                for xv in sub_blocks]
        split_phases: List[List[str]] = []
        final_phase = sub_block_phases[0]
        split_start = 0
        for i in range(1, len(sub_block_phases)):
            step_phases = [final_phase, sub_block_phases[i]]
            used_vars = math.ceil(
                sum(sum(len(y) for y in x) for x in step_phases) / 2)
            new_phase = sub_block_phase(
                list(variants[split_start:split_start + used_vars]), ac,
                step_phases)
            if "-" in new_phase[0]:
                split_phases += [final_phase]
                split_start = used_vars
                final_phase = sub_block_phases[i]
            else:
                final_phase = new_phase
        final_blocks = split_phases + [final_phase]

    out_phase: List[List[Tuple[int, str]]] = []
    variant_index = 0
    for block in final_blocks:
        out_block: List[Tuple[int, str]] = []
        for allele in block[0]:
            out_block.append((variants[variant_index], allele))
            variant_index += 1
        if out_block and "-" not in out_block[0][1]:
            out_phase.append(out_block)
    return out_phase
