"""A tiny CPU rehearsal of chip_smoke.py: the same phase functions the card
runs, at small sizes, with the device path forced onto XLA:CPU
(PANMAP_DEVICE=1) and compared with the host references."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(leaves=60, genome=8000, snps_per_node=4.0, pairs=3000,
            sample_snps=6, sample_indels=4, meta_leaves=40, meta_genome=6000,
            meta_pairs=4000, top_oc=200, sw_batch=16,
            long_reads=(1500, 2500), tally_entries=20000,
            threads=1)  # no forked build workers: JAX is already up here


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def data(smoke, tmp_path_factory):
    return smoke.make_data(TINY, 3, str(tmp_path_factory.mktemp("smoke")))


@pytest.fixture
def on_device(monkeypatch):
    from panmap_tpu.align.batch import BatchAligner

    monkeypatch.setenv("PANMAP_DEVICE", "1")
    # a tiny sample defers few windows: let the device take them
    monkeypatch.setattr(BatchAligner, "MIN_DEVICE_WINDOWS", 0)


def test_single_sample_device_equals_host(smoke, data, on_device):
    """Phase (d): device placement, DP stage and tally against --host-place
    with the device off — byte-equal outputs, zero guard trips."""
    t_dev, t_host, placer = smoke.phase_single(data, "cpu")
    assert placer.stats["guard_trips"] == 0
    smoke.check_truth(data)


def test_meta_device_equals_host(smoke, data):
    """Phase (e): device scorer + f32 EM against --host-score --em-f64."""
    smoke.phase_meta(TINY, data, "cpu")


@pytest.mark.parametrize("check", ["sw", "long", "tally", "meta"])
def test_kernel_checks(smoke, data, check):
    """Phase (c) at tiny widths."""
    {"sw": lambda: smoke.check_sw(TINY, data, "cpu"),
     "long": lambda: smoke.check_long(TINY, data, "cpu"),
     "tally": lambda: smoke.check_tally(TINY),
     "meta": lambda: smoke.check_meta(TINY, data, "cpu")}[check]()


def test_clade_masses_join_parent_groups(smoke):
    """Mass moved between a node and its parent's group cancels per clade;
    groups with no parent edge between them stay apart."""
    from types import SimpleNamespace as NS

    root = NS(identifier="root", parent=None)
    a = NS(identifier="a", parent=root)
    tree = NS(all_nodes={"root": root, "a": a,
                         "b": NS(identifier="b", parent=a),
                         "b2": NS(identifier="b2", parent=a),
                         "c": NS(identifier="c", parent=root)})
    dev = {"a": 0.05, "b,b2": 0.45, "c": 0.5}
    host = {"a": 0.2, "b,b2": 0.3, "c": 0.5}
    cdev, chost = smoke.clade_masses(dev, host, tree)
    assert sorted(cdev.values()) == sorted(chost.values()) == [0.5, 0.5]
    assert cdev == chost


def test_four_card_phase_on_virtual_devices(smoke, data):
    """Phase (f) on four of the suite's virtual CPU devices."""
    smoke.phase_four(TINY, data, "cpu x4")


def test_fails_without_gpu(smoke, capsys):
    """No GPU: a non-zero exit and no result line."""
    assert smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_in_a_directory(tmp_path):
    """Without the rest of the repository the script fails and prints no
    result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_sw_program_on_card():
    """On a GPU: the SW program compiled for the card equals the numpy DP
    at a production tier (skips elsewhere)."""
    import numpy as np

    import chip_smoke

    chip_smoke.check_sw(dict(TINY, sw_batch=64),
                        {"genome": "".join(
                            "ACGT"[i] for i in np.random.default_rng(0)
                            .integers(0, 4, 8000))}, "gpu")
