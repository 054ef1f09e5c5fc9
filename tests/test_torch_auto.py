"""`--device auto`'s per-stage route (phaser_tpu_torch mapper/dispatch.py
stage_device and the AUTO_* constants of mapper.dispatch, engine.connections,
engine.blocks and engine.phasing) on the CPU.

There is no card here, so the card's part is played by the CPU: auto's
"cuda" becomes "cpu" (the kernels' plain versions) and require_device lets
auto through.  Spies on the stages' device paths and host paths show which
stage got which device; the CLI's six files stay byte-equal to phaser_tpu's
host run whatever the route.  Without a card auto raises
(tests/test_torch_dispatch.py::test_fails_loud_without_gpu_or_native_packer).
"""

import dataclasses
import filecmp

import pytest

import datagen
from phaser_tpu.engine.output_stage import PhaserOptions as JaxOptions
from phaser_tpu.engine.pipeline import run_phaser as jax_run_phaser
from phaser_tpu_torch.cli import phaser_main
from phaser_tpu_torch.engine import blocks, connections, phasing
from phaser_tpu_torch.engine.output_stage import PhaserOptions
from phaser_tpu_torch.kernels import alleles as K
from phaser_tpu_torch.mapper import dispatch as D

SUFFIXES = (".allelic_counts.txt", ".variant_connections.txt",
            ".allele_config.txt", ".haplotypes.txt",
            ".haplotypic_counts.txt", ".vcf.gz")
GEN_KW = dict(seed=53, contigs=("chr20",), contig_len=20000,
              n_variants_per_contig=120, n_reads_per_contig=1500,
              error_rate=0.01)


def test_stage_device():
    assert D.stage_device("auto", True) == "cuda"
    assert D.stage_device("auto", False) == "host"
    for dv in ("cuda", "cpu", "host"):
        assert D.stage_device(dv, True) == D.stage_device(dv, False) == dv


@pytest.fixture
def card_is_cpu(monkeypatch):
    """auto's card becomes the CPU; spies record each stage's route."""
    real = D.stage_device
    monkeypatch.setattr(D, "stage_device", lambda dv, on: (
        "cpu" if real(dv, on) == "cuda" else real(dv, on)))
    monkeypatch.setattr(D, "require_device", lambda dv: None)
    seen = {"#2 card": 0, "#2 host": 0, "#3 card": 0, "#4 card": 0,
            "#4 host": 0, "#5 card": 0}

    def spy(module, name, key):
        orig = getattr(module, name)

        def wrapped(*a, **k):
            seen[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(module, name, wrapped)
    spy(K, "ragged_join_plain", "#2 card")
    spy(D, "assign_alleles", "#2 host")
    spy(connections, "_device_pair_counts", "#3 card")
    spy(blocks, "_device_blocks", "#4 card")
    spy(blocks, "_host_blocks", "#4 host")
    spy(phasing, "_device_full_enumeration", "#5 card")
    # every stage large enough for its device path
    monkeypatch.setattr(connections, "DEVICE_PAIR_GATE", 0)
    monkeypatch.setattr(blocks, "_DEVICE_EDGE_GATE", 0)
    monkeypatch.setattr(phasing, "DEVICE_SCORE_GATE", 2)
    return seen


@pytest.mark.parametrize("pairs_on_card", [False, True])
def test_auto_routes_each_stage(tmp_path, monkeypatch, card_is_cpu,
                                pairs_on_card):
    """The CLI with --device auto: each stage goes where its module's
    AUTO_ON_CARD says (mapper.dispatch for #2, engine.connections for #3,
    here set both ways, engine.blocks for #4, engine.phasing for #5); the
    files equal phaser_tpu's host run's."""
    monkeypatch.setattr(connections, "AUTO_ON_CARD", pairs_on_card)
    vcf, bam, data = datagen.write_fixture_dir(str(tmp_path), **GEN_KW)
    ref = str(tmp_path / "host")
    jax_run_phaser(vcf=vcf, bam=bam, sample=data.sample, o=ref, mapq="10",
                   baseq=10, paired_end="1",
                   opts=JaxOptions(**dataclasses.asdict(PhaserOptions())),
                   device="host", log=lambda *x: None)
    out = str(tmp_path / "auto")
    assert phaser_main.main([
        "--vcf", vcf, "--bam", bam, "--sample", data.sample, "--mapq", "10",
        "--baseq", "10", "--paired_end", "1", "--o", out,
        "--device", "auto"]) == 0
    for sfx in SUFFIXES:
        assert filecmp.cmp(out + sfx, ref + sfx, shallow=False), sfx
    seen = card_is_cpu
    assert (seen["#2 card"] > 0) == D.AUTO_ON_CARD, seen
    assert (seen["#2 host"] > 0) == (not D.AUTO_ON_CARD), seen
    assert (seen["#3 card"] > 0) == pairs_on_card, seen
    assert (seen["#4 card"] > 0) == blocks.AUTO_ON_CARD, seen
    assert (seen["#4 host"] > 0) == (not blocks.AUTO_ON_CARD), seen
    assert (seen["#5 card"] > 0) == phasing.AUTO_ON_CARD, seen


def test_cuda_takes_the_card_for_every_stage(tmp_path, card_is_cpu,
                                             monkeypatch):
    """cuda stays "always the card" whatever auto's route: here cpu plays
    it (the route applies to auto alone)."""
    vcf, bam, data = datagen.write_fixture_dir(str(tmp_path), **GEN_KW)
    out = str(tmp_path / "cpu")
    assert phaser_main.main([
        "--vcf", vcf, "--bam", bam, "--sample", data.sample, "--mapq", "10",
        "--baseq", "10", "--paired_end", "1", "--o", out,
        "--device", "cpu"]) == 0
    seen = card_is_cpu
    assert seen["#2 card"] > 0 and seen["#3 card"] > 0 and \
        seen["#4 card"] > 0 and seen["#5 card"] > 0, seen
    assert seen["#4 host"] == 0, seen
