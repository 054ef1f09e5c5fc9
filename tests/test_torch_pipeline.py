"""The phaser_tpu_torch engine slice end to end: its run_phaser and CLI
(device "cpu": the allele kernels' plain PyTorch versions) must write the
six output files byte-identical to phaser_tpu's run_phaser(device="host");
the port must never import jax and must fail loudly where it cannot run."""

import dataclasses
import filecmp
import os
import re
import subprocess
import sys

import pytest
import torch

import datagen
from phaser_tpu.engine.output_stage import PhaserOptions as JaxOptions
from phaser_tpu.engine.pipeline import run_phaser as jax_run_phaser
from phaser_tpu_torch.cli import phaser_main
from phaser_tpu_torch.engine.output_stage import PhaserOptions
from phaser_tpu_torch.engine.pipeline import run_phaser


def _jax_opts(opts):
    """phaser_tpu's own options object with the port options' values."""
    return JaxOptions(**dataclasses.asdict(opts))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIXES = (".allelic_counts.txt", ".variant_connections.txt",
            ".allele_config.txt", ".haplotypes.txt",
            ".haplotypic_counts.txt", ".vcf.gz")
GEN_KW = [
    dict(seed=51, contigs=("chr20",), contig_len=20000,
         n_variants_per_contig=100, n_reads_per_contig=1500,
         error_rate=0.01),
    dict(seed=52, contigs=("chr20", "chr21"), contig_len=15000,
         n_variants_per_contig=80, n_reads_per_contig=900,
         include_indel_variants=True, frac_indel_reads=0.2,
         frac_multiallelic=0.15),
]


@pytest.fixture(autouse=True)
def _cap_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))


def _assert_same_outputs(a, b):
    for suffix in SUFFIXES:
        assert filecmp.cmp(a + suffix, b + suffix, shallow=False), suffix


def _reference(tmp_path, gen_kw, opts):
    vcf, bam, data = datagen.write_fixture_dir(str(tmp_path), **gen_kw)
    ref = str(tmp_path / "host")
    jax_run_phaser(vcf=vcf, bam=bam, sample=data.sample, o=ref, mapq="10",
                   baseq=10, paired_end="1", opts=_jax_opts(opts),
                   device="host", log=lambda *x: None)
    return vcf, bam, data.sample, ref


@pytest.mark.parametrize("gen_kw", GEN_KW)
def test_run_phaser_cpu_matches_phaser_tpu_host(tmp_path, gen_kw):
    opts = PhaserOptions(include_indels=1)
    vcf, bam, sample, ref = _reference(tmp_path, gen_kw, opts)
    out = str(tmp_path / "port")
    run_phaser(vcf=vcf, bam=bam, sample=sample, o=out, mapq="10", baseq=10,
               paired_end="1", opts=opts, device="cpu", log=lambda *x: None)
    _assert_same_outputs(out, ref)


@pytest.mark.parametrize("gen_kw", GEN_KW)
def test_cli_cpu_matches_without_importing_jax(tmp_path, gen_kw):
    """The port's CLI in a fresh process: byte-identical outputs, the
    kernel-launch line, and jax never imported."""
    vcf, bam, sample, ref = _reference(tmp_path, gen_kw, PhaserOptions())
    out = str(tmp_path / "cli")
    argv = ["--vcf", vcf, "--bam", bam, "--sample", sample, "--mapq", "10",
            "--baseq", "10", "--paired_end", "1", "--o", out,
            "--device", "cpu"]
    code = ("import sys\n"
            "from phaser_tpu_torch.cli.phaser_main import main\n"
            "rc = main(%r)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "sys.exit(rc)\n" % argv)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert re.search(r"kernel launches: affine_nibble=0 delta_nibble=0 "
                     r"plane=0", proc.stdout)
    assert re.search(r"device stage calls: pair_counts=0 components=0 "
                     r"phase_scores=0", proc.stdout)
    _assert_same_outputs(out, ref)


@pytest.mark.parametrize("gen_kw", GEN_KW)
def test_cli_cpu_gates_down_matches_phaser_tpu_host(tmp_path, monkeypatch,
                                                    capsys, gen_kw):
    """The port's CLI with --device cpu and the pair, edge and scorer gates
    forced down: stages #3, #4 and #5 run their device code, and the six
    outputs stay byte-identical to phaser_tpu's host run."""
    from phaser_tpu_torch.engine import blocks, connections, phasing
    vcf, bam, sample, ref = _reference(tmp_path, gen_kw, PhaserOptions())
    monkeypatch.setattr(connections, "DEVICE_PAIR_GATE", 0)
    monkeypatch.setattr(blocks, "_DEVICE_EDGE_GATE", 0)
    monkeypatch.setattr(phasing, "DEVICE_SCORE_GATE", 2)
    for counts in (connections.COUNTS, blocks.COUNTS, phasing.COUNTS):
        monkeypatch.setitem(counts, "device_calls", 0)
    out = str(tmp_path / "cli")
    rc = phaser_main.main(
        ["--vcf", vcf, "--bam", bam, "--sample", sample, "--mapq", "10",
         "--baseq", "10", "--paired_end", "1", "--o", out, "--device", "cpu"])
    assert rc == 0, capsys.readouterr().out[-2000:]
    calls = [c["device_calls"] for c in
             (connections.COUNTS, blocks.COUNTS, phasing.COUNTS)]
    assert min(calls) > 0, calls
    assert re.search(r"device stage calls: pair_counts=%d components=%d "
                     r"phase_scores=%d" % tuple(calls),
                     capsys.readouterr().out)
    _assert_same_outputs(out, ref)


def _cli_args(tmp_path, *extra):
    vcf, bam, data = datagen.write_fixture_dir(
        str(tmp_path), seed=53, contigs=("chr20",), contig_len=8000,
        n_variants_per_contig=30, n_reads_per_contig=200)
    return ["--vcf", vcf, "--bam", bam, "--sample", data.sample, "--mapq",
            "10", "--baseq", "10", "--paired_end", "1",
            "--o", str(tmp_path / "out")] + list(extra)


@pytest.mark.parametrize("extra,message", [
    (("--process_slow", "1", "--device", "cuda"), "CUDA GPU"),
    (("--threads", "2", "--device", "cuda"), "CUDA GPU"),
    (("--device", "cuda"), "CUDA GPU"),
    (("--device", "auto"), "CUDA GPU"),
])
def test_cli_fails_loud(tmp_path, capsys, extra, message):
    if "CUDA" in message and torch.cuda.is_available():
        pytest.skip("a GPU is present")
    rc = phaser_main.main(_cli_args(tmp_path, *extra))
    assert rc == 1
    assert message in capsys.readouterr().out
    assert os.path.exists(str(tmp_path / "out") + ".failure.json")
    assert not os.path.exists(str(tmp_path / "out") + ".haplotypes.txt")


@pytest.mark.parametrize("kw", [dict(threads=2), dict(shard_plan=object()),
                                dict(dist_reduce=object())])
def test_run_phaser_rejects_unported_runners(tmp_path, kw):
    """The runners' arguments are served now (tests/test_torch_threads.py);
    what run_phaser still rejects before any work: a shard plan without a
    reducer, and --device cuda without a card, whatever the runner."""
    if "shard_plan" in kw:
        err, match = ValueError, "shard_plan requires dist_reduce"
    elif torch.cuda.is_available():
        pytest.skip("a GPU is present")
    else:
        err, match = RuntimeError, "needs a CUDA GPU"
    with pytest.raises(err, match=match):
        run_phaser(vcf="", bam="", sample="", o=str(tmp_path / "out"),
                   mapq="10", baseq=10, paired_end="1", device="cuda",
                   log=lambda *x: None, **kw)


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "phaser_tpu_torch")):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    assert len(paths) > 8
    bad = [p for p in paths if pat.search(open(p).read())]
    assert not bad, bad


def test_kernel_module_imports_without_nvcc_or_triton(tmp_path):
    code = ("import sys\n"
            "import phaser_tpu_torch.cli.phaser_main\n"
            "import phaser_tpu_torch.engine.blocks\n"
            "import phaser_tpu_torch.engine.connections\n"
            "import phaser_tpu_torch.engine.phasing\n"
            "import phaser_tpu_torch.kernels.alleles\n"
            "import phaser_tpu_torch.kernels.components\n"
            "import phaser_tpu_torch.kernels.paircount\n"
            "import phaser_tpu_torch.kernels.phasescore\n"
            "import phaser_tpu_torch.mapper.dispatch\n"
            "from phaser_tpu_torch.utils import build\n"
            "assert build._lib is None\n"
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no_cuda"),
               CUDA_PATH=str(tmp_path / "no_cuda"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# the card is the default of every library entry point

def _entry_points():
    from phaser_tpu_torch.dist import engine_multihost as M
    from phaser_tpu_torch.engine import blocks, connections, phasing
    from phaser_tpu_torch.engine.slow_mode import run_phaser_slow
    return {
        "run_phaser": run_phaser,
        "run_phaser_slow": run_phaser_slow,
        "run_phaser_sharded_threads": M.run_phaser_sharded_threads,
        "run_phaser_multihost": M.run_phaser_multihost,
        "run_phaser_multiproc": M.run_phaser_multiproc,
        "build_connections": connections.build_connections,
        "find_blocks": blocks.find_blocks,
        "phase_v3": phasing.phase_v3,
        "sub_block_phase": phasing.sub_block_phase,
    }


ENTRY_NAMES = ["run_phaser", "run_phaser_slow", "run_phaser_sharded_threads",
               "run_phaser_multihost", "run_phaser_multiproc",
               "build_connections", "find_blocks", "phase_v3",
               "sub_block_phase", "engine_multihost --device"]


@pytest.mark.parametrize("name", ENTRY_NAMES)
def test_entry_point_defaults_to_the_card(tmp_path, name):
    """Called without `device`, an entry point runs on the card: its
    default is "cuda", and on a machine without a card it raises before it
    computes anything, as the CLI does."""
    import inspect
    from types import SimpleNamespace

    from phaser_tpu_torch.dist import engine_multihost as M
    no_card = not torch.cuda.is_available()
    run = dict(vcf="missing.vcf.gz", bam="missing.bam", sample="S",
               o=str(tmp_path / "o"), mapq="10", baseq=10, paired_end="1")
    if name == "engine_multihost --device":
        argv = ["--vcf", run["vcf"], "--bam", run["bam"], "--sample", "S",
                "--o", run["o"], "--num-processes", "1", "--process-id", "0"]
        if no_card:
            with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
                M._mp_main(argv)
        return
    fn = _entry_points()[name]
    if name == "run_phaser":  # a **kwargs wrapper around the engine
        from phaser_tpu_torch.engine.pipeline import _run_phaser_inner
        sig = inspect.signature(_run_phaser_inner)
    else:
        sig = inspect.signature(fn)
    assert sig.parameters["device"].default == "cuda"
    if not no_card:
        return
    calls = {
        "run_phaser": lambda: fn(**run),
        "run_phaser_slow": lambda: fn(**run),
        "run_phaser_sharded_threads": lambda: fn(n_shards=2, **run),
        "run_phaser_multihost": lambda: fn(num_processes=1, process_id=0,
                                           **run),
        "run_phaser_multiproc": lambda: fn(2, opts=PhaserOptions(), **run),
        "build_connections": lambda: fn(None, 0.002, 0.01),
        "find_blocks": lambda: fn(SimpleNamespace(adj={}), None),
        "phase_v3": lambda: fn([0, 1], {}, {}, 15),
        "sub_block_phase": lambda: fn([0, 1], {}),
    }
    # the inputs do not exist: reaching them would raise something else
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        calls[name]()


def test_profile_dir_hook_writes_a_torch_profiler_trace(tmp_path, monkeypatch):
    """PHASER_TPU_PROFILE_DIR: a run's outermost span takes the process's
    one trace and writes it there as a Chrome trace when it closes, holding
    the spans of its tracer's stages (with a card, the card's own activity
    beside them; never CPU ops); a second run alive at the same time (a
    shard thread) with its own tracer nests no profiler and writes no
    file of its own; once the variable is unset no file is written."""
    import json
    import threading

    from phaser_tpu_torch.utils import trace
    from phaser_tpu_torch.utils.trace import Tracer
    prof = tmp_path / "prof"
    monkeypatch.setenv("PHASER_TPU_PROFILE_DIR", str(prof))
    trace.clear_spans()

    def second_run(seen):
        with trace.root_span("phaser run"):
            seen["profiler"] = torch._C._autograd._profiler_enabled()
            second = Tracer()
            with second.stage("#2 shard work"):
                pass

    seen = {}
    with trace.root_span("phaser run"):
        first = Tracer()
        with first.stage("#1 work", "items"):
            torch.arange(1000).sum()
        first.add("#1 work", 3, "items")
        t = threading.Thread(target=second_run, args=(seen,))
        t.start()
        t.join()
        assert os.listdir(str(prof)) == []
    assert seen == {"profiler": False}
    traces = os.listdir(str(prof))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(str(prof / traces[0])) as fh:
        data = json.load(fh)
    spans = {e["name"]: e for e in data["traceEvents"]
             if e.get("cat") == "phaser_span"}
    assert sorted(spans) == ["#1 work", "#2 shard work", "phaser run"]
    assert spans["#1 work"]["args"]["items"] == 3
    assert spans["#1 work"]["dur"] > 0
    assert spans["#2 shard work"]["tid"] != spans["#1 work"]["tid"]
    assert isinstance(data["baseTimeNanoseconds"], int)
    assert not any(e.get("cat") in ("cpu_op", "python_function",
                                    "user_annotation")
                   for e in data["traceEvents"])
    assert not torch._C._autograd._profiler_enabled()
    monkeypatch.delenv("PHASER_TPU_PROFILE_DIR")
    with trace.root_span("phaser run") as sp:
        with Tracer().stage("#1 work"):
            pass
    assert sp is None and os.listdir(str(prof)) == traces
    trace.clear_spans()
