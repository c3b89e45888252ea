"""Multi-process ("multi-host without a cluster", SURVEY §4.5) tests: N
separate JAX processes with virtual CPU devices initialize jax.distributed
against a localhost coordinator and run the sharded scoring program over the
GLOBAL mesh.  The reference has no analog (single-process TBB); this is the
build's own multi-host story (SURVEY §5.8)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("nprocs,devs", [(2, 4)])
def test_multiprocess_sharded_scoring(nprocs, devs):
    """2 processes x 4 virtual CPU devices: the global-mesh sharded placement
    scoring program must match an independent f64 oracle in every process
    (see tools/dist_smoke.py)."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "dist_smoke.py"),
         str(nprocs), str(devs)],
        capture_output=True, text=True, timeout=280, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.stdout.count("OK") == nprocs, r.stdout


def test_dist_scaffolding_noop_without_flags():
    """maybe_initialize is a no-op (returns False) without flags/env — the
    single-process path must never touch jax.distributed."""
    env = dict(os.environ)
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    env.update(JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c",
         "from panmap_tpu.parallel.dist import maybe_initialize, "
         "process_read_shard\n"
         "assert maybe_initialize() is False\n"
         "assert process_read_shard(10) == slice(0, 10)\n"
         "print('NOOP-OK')"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "NOOP-OK" in r.stdout


@pytest.mark.e2e
def test_multiprocess_place_exact_real_index():
    """VERDICT r3 #3: 2 processes x 4 virtual devices running the PRODUCTION
    place_exact over the global mesh on the REAL rsv_4K index must byte-match
    the single-process f64 host engine in every process (tools/dist_real.py)."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "dist_real.py"), "2", "4"],
        capture_output=True, text=True, timeout=580, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.stdout.count("OK") == 2, r.stdout


@pytest.mark.e2e
def test_multiprocess_batch_manifest_shard_union():
    """VERDICT r3 #3: the multi-host manifest shard of run_batch
    (pipeline.run_batch + parallel.dist.process_read_shard).  Two CLI
    processes under jax.distributed each take their contiguous shard of a
    4-sample manifest; the union of their outputs must equal the
    single-process batch run byte-for-byte (placement.tsv, vcf, consensus)."""
    import socket
    import tempfile

    sys.path.insert(0, REPO)
    from tools.dist_real import DEFAULT_IDX, PANMAN, _ensure_index

    _ensure_index(DEFAULT_IDX)
    data = "/root/reference/src/test/data"
    reads = [f"{data}/MZ515733.1.fastq", f"{data}/MZ515733.1.fa",
             f"{data}/rsv_4K.panman.random.node_1330.fa",
             f"{data}/MZ515733.1.fastq"]
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")

    def run_batch_cli(outdir, dist=None):
        manifest = os.path.join(outdir, "batch.tsv")
        with open(manifest, "w") as fh:
            for i, rd in enumerate(reads):
                fh.write(f"{rd} {outdir}/s{i}\n")
        cmd = [sys.executable, "-m", "panmap_tpu", PANMAN, "--batch",
               manifest, "--index", DEFAULT_IDX]
        if dist is not None:
            coord, nprocs, pid = dist
            cmd += ["--dist-coordinator", coord, "--dist-nprocs",
                    str(nprocs), "--dist-pid", str(pid)]
            return subprocess.Popen(cmd, env=env, cwd=REPO,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=560)
        assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
        return None

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        run_batch_cli(d1)  # single-process reference run
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [run_batch_cli(d2, (f"localhost:{port}", 2, pid))
                 for pid in (0, 1)]
        outs = [p.communicate(timeout=560)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)
        # every process must only have produced ITS shard (2 samples each)
        assert any("[batch] process shard: samples [0, 2)" in o
                   for o in outs), outs
        assert any("[batch] process shard: samples [2, 4)" in o
                   for o in outs), outs
        for i in range(len(reads)):
            for suffix in (".placement.tsv", ".vcf", ".consensus.fa"):
                a = open(f"{d1}/s{i}{suffix}", "rb").read()
                b = open(f"{d2}/s{i}{suffix}", "rb").read()
                assert a == b, (i, suffix)


@pytest.mark.e2e
def test_multiprocess_sharded_em_real_data():
    """Sharded SQUAREM EM over a global 2-process x 4-device mesh on a REAL
    rsv_4K score matrix: the fused EM body must be sharding-invariant
    (global mesh == process-local mesh, every process; tools/dist_real.py
    --em)."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "dist_real.py"),
         "2", "4", "--em"],
        capture_output=True, text=True, timeout=580, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.stdout.count("OK") == 2, r.stdout
