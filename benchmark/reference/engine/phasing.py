"""Block phasing: a frozen copy of the host route of
phaser_tpu_torch/engine/phasing.py, with the device scorer left out (its
scores are exact integers, so the outputs are the same either way).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


AlleleConn = Dict[Tuple[int, int], Set[Tuple[int, int]]]

_INV_TABLE = str.maketrans("01", "10")


def inverse_config(config: str) -> str:
    return config.translate(_INV_TABLE)


def _component_of_first_key(ac: AlleleConn) -> Set[Tuple[int, int]]:
    keys = iter(ac)
    seed_key = next(keys)
    comp = set([seed_key]) | set(ac[seed_key])
    remaining = set(ac.keys()) - {seed_key}
    overlapping = comp & remaining
    while overlapping:
        for node in overlapping:
            comp |= ac[node]
            remaining.discard(node)
        overlapping = comp & remaining
    return comp


def resolve_phase(variants: Sequence[int], ac: AlleleConn,
                  clean_connections: bool = False) -> Optional[List[List[str]]]:
    """resolve_phase (:2172-2207): if the allele graph's first component has
    exactly one node per variant, the phase is read-consistent."""
    if clean_connections:
        sv = set(variants)
        # iterate sub-block variants directly (equivalent to filtering the
        # whole-block dict: keys there are in sorted-variant (v,0),(v,1)
        # order and sub-blocks are contiguous slices, so the first cleaned
        # key — the component seed — is identical)
        cleaned: AlleleConn = {}
        for v in variants:
            for a in (0, 1):
                key = (v, a)
                if key in ac:
                    cleaned[key] = {c for c in ac[key] if c[0] in sv}
        ac = cleaned
    if not ac:
        return None
    comp = _component_of_first_key(ac)
    if len(comp) == len(variants):
        out = ""
        for v in variants:
            if (v, 0) in comp:
                out += "0"
            elif (v, 1) in comp:
                out += "1"
        return [[out, inverse_config(out)]]
    return None


def _score_configs(variants: Sequence[int], ac: AlleleConn,
                   configs: List[str]) -> np.ndarray:
    """Directed supporting-edge count per configuration: sum over ordered
    (variant, other) pairs of 1[(other, other_allele) in ac[(variant, allele)]]
    — computed as v^T M v with the 2n x 2n allele adjacency."""
    n = len(variants)
    local = {v: i for i, v in enumerate(variants)}
    M = np.zeros((2 * n, 2 * n), np.int32)
    for i, v in enumerate(variants):
        for a in (0, 1):
            conns = ac.get((v, a))
            if not conns:
                continue
            for (w, b) in conns:
                j = local.get(w)
                if j is not None and w != v:
                    M[i * 2 + a, j * 2 + b] = 1
    S = len(configs)
    V = np.zeros((S, 2 * n), np.int32)
    for s, cfg in enumerate(configs):
        for i, ch in enumerate(cfg[:n]):
            if ch != "-":
                V[s, i * 2 + int(ch)] = 1
    return _vmv_scores(V, M)


def _vmv_scores(V: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Batched v^T M v over 0/1 rows, through BLAS: float32 sgemm then a
    fused row dot — ~10x numpy's generic int einsum path at 2^14 rows,
    exact (intermediates are small integers, < 2^24)."""
    Vf = V.astype(np.float32)
    return ((Vf @ M.astype(np.float32)) * Vf).sum(1).astype(np.int64)



def sub_block_phase(variants: Sequence[int], ac: AlleleConn,
                    sub_block_configs: Optional[List[List[str]]] = None,
                    attempt_resolve: bool = False) -> List[str]:
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


def _enumerate_phase_host(variants: Sequence[int], ac: AlleleConn,
                          n: int) -> List[str]:
    """Vectorized host enumeration: score all 2^(n-1) complement classes
    as one einsum over bit-pattern one-hots (identical scores and
    iteration order to the string path it replaces)."""
    local = {v: i for i, v in enumerate(variants)}
    M = np.zeros((2 * n, 2 * n), np.int32)
    for i, v in enumerate(variants):
        for a in (0, 1):
            for (w, b) in ac.get((v, a), ()):
                j = local.get(w)
                if j is not None and w != v:
                    M[i * 2 + a, j * 2 + b] = 1
    S = 2 ** max(n - 1, 0)
    bits = np.arange(S, dtype=np.int64)
    # column i of the config = bit (n-1-i) of `bits`, with column 0 fixed 0
    alleles = np.zeros((S, n), np.int8)
    if n > 1:
        shifts = np.arange(n - 2, -1, -1, dtype=np.int64)
        alleles[:, 1:] = ((bits[:, None] >> shifts[None, :]) & 1)
    V = np.zeros((S, 2 * n), np.int32)
    rows = np.repeat(np.arange(S), n)
    cols = (2 * np.arange(n)[None, :] + alleles).reshape(-1)
    V[rows, cols] = 1
    scores = _vmv_scores(V, M)
    max_support = int(scores.max())
    best = np.flatnonzero(scores == max_support)
    if len(best) == 1:
        b = int(best[0])
        cfg = "0" + format(b, "0%db" % (n - 1)) if n > 1 else "0"
        return [cfg, inverse_config(cfg)]
    return ["-" * n, "-" * n]


def find_weak_points(variants: Sequence[int],
                     variant_connections: Dict[int, Set[int]]) -> Dict[int, int]:
    """Connections crossing each inter-variant point (:2309-2324).

    The reference increments every position in [lo, hi] per edge —
    O(edges x span), quadratic on dense WGS blocks. Here each edge adds
    +1/-1 to a difference array and one prefix sum recovers identical
    counts in O(edges + n).
    """
    n = len(variants)
    index = {v: i for i, v in enumerate(variants)}
    diff = np.zeros(n + 1, np.int64)
    for xvar, conns in variant_connections.items():
        i = index[xvar]
        for c in conns:
            j = index[c]
            if i < j:
                lo = max(i + 1, 2)
                hi = min(j, n - 2)
                if lo <= hi:
                    diff[lo] += 1
                    diff[hi + 1] -= 1
    crossing = np.cumsum(diff)
    return {p: int(crossing[p]) for p in range(2, n - 1)}


def split_variants(variants: Sequence[int], split_points: List[int]) -> List[List[int]]:
    split_points = sorted(split_points)
    out = []
    for i in range(len(split_points) + 1):
        if i == 0:
            out.append(list(variants[:split_points[i]]))
        elif i < len(split_points):
            out.append(list(variants[split_points[i - 1]:split_points[i]]))
        else:
            out.append(list(variants[split_points[i - 1]:]))
    return out


def split_by_weak(variants: Sequence[int],
                  variant_connections: Dict[int, Set[int]],
                  max_size: int) -> List[List[int]]:
    """split_by_weak (:2271-2294), including cumulative split_points and the
    adjacent-point exclusion."""
    weak_points = find_weak_points(variants, variant_connections)
    haplo_fragments: List[List[int]] = []
    split_points: List[int] = []
    split_at = 1
    max_frag = len(variants)
    guard = 0
    while max_frag > max_size or split_at == 1:
        for position in sorted(weak_points.keys()):
            if weak_points[position] == split_at:
                if position + 1 not in split_points and position - 1 not in split_points:
                    split_points.append(position)
        if split_points:
            haplo_fragments = split_variants(variants, split_points)
        else:
            haplo_fragments = [list(variants)]
        max_frag = max(len(x) for x in haplo_fragments)
        split_at += 1
        guard += 1
        if guard > 10 * len(variants) + 100:
            # the reference can spin here for max_block_size < 3; bail with
            # current fragments rather than hang
            break
    return haplo_fragments


def phase_v3(variants: Sequence[int],
             variant_connections: Dict[int, Set[int]],
             ac: AlleleConn, max_block_size: int
             ) -> List[List[Tuple[int, str]]]:
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
            sub_block_phases = [sub_block_phase(xv, ac)
                                for xv in sub_blocks]
        else:
            sub_block_phases = [sub_block_phase(xv, ac, attempt_resolve=True)
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
