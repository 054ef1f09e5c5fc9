"""Runs of the harness with the program broken underneath come out not
correct: half of each BAM's reads left out, a hit's allele altered where
#2 produces it, and a pass that returns having done nothing (the exchange
between chips does not exist in a one-chip cell)."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import Args, load_run

CELL = "small_dna.small_wgs30x"


def _half(fn):
    def wrapped(*a, **kw):
        bd = fn(*a, **kw)
        return bd.select(np.arange(len(bd)) % 2 == 0)
    return wrapped


def _alter(fn):
    def wrapped(pendings):
        out = fn(pendings)
        for hits in out:
            if len(hits):
                hits.allele_code[0] = 1 if hits.allele_code[0] != 1 else 2
                break
        return out
    return wrapped


def break_half(mp):
    from phaser_tpu_torch.io import bam, bam_index
    mp.setattr(bam, "read_bam", _half(bam.read_bam))
    mp.setattr(bam_index, "read_bam_voffset_ranges",
               _half(bam_index.read_bam_voffset_ranges))


def break_allele(mp):
    from phaser_tpu_torch.mapper import dispatch
    mp.setattr(dispatch, "resolve_all", _alter(dispatch.resolve_all))


def break_nothing_done(mp):
    from phaser_tpu_torch.cli import phaser_main
    from phaser_tpu_torch.engine.pipeline import PhaserResult
    mp.setattr(phaser_main, "run_phaser", lambda **kw: PhaserResult())


@pytest.mark.parametrize("fault", [break_half, break_allele,
                                   break_nothing_done],
                         ids=["half_reads", "allele_altered", "nothing_done"])
def test_a_broken_program_is_not_correct(checkout, monkeypatch, fault):
    run = load_run(checkout)
    fault(monkeypatch)
    res = run.run(Args(CELL), device="cpu", require_card=False,
                  root=str(checkout))
    assert res["correct"] is False
