#!/usr/bin/env python
"""Smoke run of panmap-tpu on a GPU.

Generates a pangenome and reads from a seed, checks every device program
against its plain reference at real widths, then drives the single-sample
path and the --meta path through the configuration the CLI builds, and
compares the device results with the host references.

    python chip_smoke.py                # one GPU: phases a-e
    python chip_smoke.py --four-cards   # four GPUs: the --mesh 4 paths only

Phases: (a) environment, (b) data generation and index builds on the host,
before the first device call (the builders fork workers), (c) device
programs against their references, (d) single-sample pipeline, device
defaults against --host-place with the device off, (e) --meta, device
scorer and EM against --host-score --em-f64, run to the likelihood maximum
and at the CLI defaults, (f) --four-cards: --mesh 4
placement, sharded meta scorer and sharded EM against one card.

Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the upstream demos' scales: sars_20000 (20,000 genomes of ~30 kb, 102,338
# paired 150 bp isolate reads) and rsv_4K (4,000 genomes of ~15 kb)
FULL = dict(leaves=20000, genome=30000, snps_per_node=4.0, pairs=51169,
            sample_snps=20, sample_indels=10, meta_leaves=4000, meta_genome=15000,
            meta_pairs=200000, top_oc=1000, sw_batch=4096, long_reads=(5000, 8000, 11000,
                                                          14000, 17000, 20000),
            tally_entries=102338 * 150)
# cuts to stay inside the run's time limit (each printed on its own line)
CUTS = dict(meta_pairs=(20000, "the host f64 EM reference costs O(reads x "
                               "candidates) per iteration"),
            top_oc=(200, "EM candidates (--top-oc; default 1000), for the "
                         "same reason"))
MIX_PROPS = (0.50, 0.25, 0.13, 0.08, 0.04)
EM_TOL = 2e-4  # f32 device EM vs the host f64 EM (meta/engine.py gate)
# Run to the likelihood maximum, the f32 and f64 EMs agree per group within
# EM_TOL.  At the CLI default (--em-convergence-threshold 1e-5) the
# |llh gain| < eta stop lands at a different point of a flat likelihood
# ridge depending on rounding: mass moves between a haplotype and its parent
# (a few SNPs apart), so per group they differ by more than EM_TOL, and the
# default run is held to EM_TOL on the mass of each parent-joined clade.
EM_ARGS = ["--em-convergence-threshold", "1e-8",
           "--em-maximum-iterations", "10000"]
EM_KW = dict(eta=1e-8, max_iterations=10000)


def say(msg: str) -> None:
    print(msg, flush=True)


class Fail(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise Fail(msg)


def card_line() -> str:
    """Name and power limit as nvidia-smi reports them (a child process
    that stays off JAX); one line per distinct card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.split("\n")
    except (OSError, subprocess.TimeoutExpired):
        out = []
    lines = [ln.strip() for ln in out if ln.strip()]
    return " | ".join(dict.fromkeys(lines)) or "nvidia-smi unavailable"


def probe_platform() -> str:
    """Platform of JAX's first device, asked in a child process so that
    this process opens the card only after the forking index builders."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True)
    return r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""


class StageLog:
    """cfg.log for the pipeline: timestamps every line so the stage wall
    times can be printed."""

    def __init__(self, tag: str):
        self.tag = tag
        self.t0 = time.perf_counter()

    def __call__(self, *args, **_kw):
        msg = " ".join(str(a) for a in args)
        say(f"  [{self.tag} +{time.perf_counter() - self.t0:8.3f}s] {msg}")


# ---------------------------------------------------------------- phase (b)
def make_data(sc: dict, seed: int, work: str) -> dict:
    """Trees, reads and indexes, all on the host."""
    from panmap_tpu import synth
    from panmap_tpu.__main__ import build_parser, meta_config, pipeline_config
    from panmap_tpu.meta.driver import ensure_meta_index
    from panmap_tpu.pipeline import ensure_index

    d = dict(work=work)
    t0 = time.perf_counter()
    tree = synth.make_tree(seed, sc["leaves"], sc["genome"],
                           snps_per_node=sc["snps_per_node"])
    leaves = synth.leaf_names(tree)
    leaf = leaves[len(leaves) // 2]
    genome, truth = synth.sample_genome(tree, leaf, sc["sample_snps"],
                                        seed + 1, sc["sample_indels"])
    r1, r2 = synth.simulate_pairs(genome, sc["pairs"], seed + 2)
    d["reads"] = synth.write_pairs(os.path.join(work, "sample"), r1, r2)
    d.update(tree=tree, leaf=leaf, genome=genome, truth=truth)
    say(f"[b] single-sample tree: {len(tree.dfs_order)} nodes, "
        f"{len(leaves)} genomes of {sc['genome']} bp; {2 * sc['pairs']} "
        f"reads from {leaf} + {sc['sample_snps']} planted SNPs and "
        f"{sc['sample_indels']} indels "
        f"({time.perf_counter() - t0:.1f}s)")

    d["panman"] = os.path.join(work, "synthetic.panman")  # no file: the
    d["index"] = os.path.join(work, "synthetic.ptidx.npz")  # tree is passed
    # -t: index-build workers (0 = every core); the builders fork them
    threads = ["-t", str(sc.get("threads", 0))]
    args = build_parser().parse_args(
        [d["panman"], *d["reads"], "-i", d["index"], "--stop", "index"]
        + threads)
    t0 = time.perf_counter()
    idx, _ = ensure_index(pipeline_config(args, "", lambda *a: None), tree)
    d["idx"] = idx
    say(f"[b] index: {len(idx.seed_hashes)} seed-change rows, "
        f"{len(idx.node_ids)} nodes, built in "
        f"{time.perf_counter() - t0:.1f}s on {os.cpu_count()} cores")

    t0 = time.perf_counter()
    mtree = synth.make_tree(seed + 10, sc["meta_leaves"], sc["meta_genome"],
                            snps_per_node=sc["snps_per_node"])
    mleaves = synth.leaf_names(mtree)
    rng = np.random.default_rng(seed + 11)
    haps = [mleaves[i] for i in rng.choice(len(mleaves), len(MIX_PROPS),
                                           replace=False)]
    m1, m2 = synth.mixture_pairs([mtree.get_string(h) for h in haps],
                                 MIX_PROPS, sc["meta_pairs"], seed + 12)
    d["meta_reads"] = synth.write_pairs(os.path.join(work, "mix"), m1, m2)
    d.update(meta_tree=mtree, haps=haps)
    d["meta_panman"] = os.path.join(work, "synthetic_meta.panman")
    d["meta_index"] = os.path.join(work, "synthetic_meta.ptmidx.npz")
    margs = build_parser().parse_args(
        ["--meta", d["meta_panman"], *d["meta_reads"],
         "--index-out", d["meta_index"]] + threads)
    midx, _ = ensure_meta_index(meta_config(margs, "", lambda *a: None),
                                mtree)
    d["midx"] = midx
    say(f"[b] meta tree: {len(mtree.dfs_order)} nodes, {len(mleaves)} "
        f"genomes of {sc['meta_genome']} bp; {2 * len(m1)} reads from "
        f"{len(haps)} haplotypes at {MIX_PROPS}; meta index "
        f"{len(midx.delta_seed)} deltas ({time.perf_counter() - t0:.1f}s)")
    return d


# ---------------------------------------------------------------- phase (c)
def _sw_cases(rng, genome_codes, n, lq_max, lw_max):
    """n (query, window) pairs filling an (LQ, LW) tier: each query is a
    mutated copy of part of its window (SNPs and one indel)."""
    L = len(genome_codes)
    qs, ws = [], []
    for _ in range(n):
        lw = int(rng.integers(lw_max // 2 + 1, lw_max + 1))
        lq = int(rng.integers(lq_max // 2 + 1, lq_max + 1))
        p = int(rng.integers(0, L - lw))
        w = genome_codes[p:p + lw].copy()
        o = int(rng.integers(0, max(lw - lq, 1)))
        q = w[o:o + lq].copy()
        hit = rng.random(len(q)) < 0.02
        q[hit] = (q[hit] + 1) % 4
        if rng.random() < 0.5 and len(q) > 40:
            c = int(rng.integers(10, len(q) - 20))
            g = int(rng.integers(1, 8))
            q = np.concatenate([q[:c], q[c + g:]]) if rng.random() < 0.5 \
                else np.concatenate([q[:c], rng.integers(0, 4, g).astype(
                    np.uint8), q[c:]])[:lq]
        qs.append(q)
        ws.append(w)
    return qs, ws


def check_sw(sc, d, card):
    from concurrent.futures import ThreadPoolExecutor

    from panmap_tpu.align.batch import BatchAligner
    from panmap_tpu.align.core import MIN_DP_MAX, banded_affine_dp, encode
    from panmap_tpu.align.sw_device import banded_sw_scores
    from panmap_tpu.native import banded_dp_native

    rng = np.random.default_rng(5)
    gcodes = encode(np.frombuffer(d["genome"].encode(), np.uint8))
    B = sc["sw_batch"]
    threads = min(8, os.cpu_count() or 1)

    def host_dp(qw):
        return banded_dp_native(*qw) or banded_affine_dp(*qw)

    for lq in BatchAligner._LQ_TIERS:
        for lw in BatchAligner._LW_TIERS:
            qs, ws = _sw_cases(rng, gcodes, B, lq, lw)
            qb = np.full((B, lq), 4, np.uint8)
            rb = np.full((B, lw), 4, np.uint8)
            ql = np.zeros(B, np.int32)
            for i, (q, w) in enumerate(zip(qs, ws)):
                qb[i, :len(q)] = q
                rb[i, :len(w)] = w
                ql[i] = len(q)
            t0 = time.perf_counter()
            out = np.asarray(banded_sw_scores(qb, rb, ql))
            t_first = time.perf_counter() - t0
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                banded_sw_scores(qb, rb, ql).block_until_ready()
                times.append(time.perf_counter() - t0)
            with ThreadPoolExecutor(threads) as ex:
                t0 = time.perf_counter()
                ref = list(ex.map(host_dp, zip(qs, ws)))
                t_host = time.perf_counter() - t0
            bad = 0
            for i, r in enumerate(ref):
                if r[0] <= 0:
                    bad += not (out[i, 0] < MIN_DP_MAX)
                else:
                    bad += (int(out[i, 0]), int(out[i, 1]), int(out[i, 2])) \
                        != (r[0], r[2], r[4])
            # the numpy DP itself on a sample of the pairs
            for i in range(0, B, B // 8):
                r = banded_affine_dp(qs[i], ws[i])
                if r[0] > 0:
                    bad += (int(out[i, 0]), int(out[i, 1]),
                            int(out[i, 2])) != (r[0], r[2], r[4])
            say(f"[c] sw LQ={lq} LW={lw} B={B}: exact {B - bad}/{B}; device "
                f"{np.median(times) * 1e3:.2f} ms (first call incl. compile "
                f"{t_first:.2f}s), host native DP {t_host * 1e3:.1f} ms "
                f"({t_host / B * 1e6:.1f} us/window, {threads} threads) "
                f"[{card}]")
            check(bad == 0, f"sw tier ({lq},{lw}): {bad} mismatches")


def _ont_read(rng, genome, length):
    frag = np.frombuffer(genome.encode(), np.uint8)
    p = int(rng.integers(0, len(frag) - length))
    frag = frag[p:p + length]
    u = rng.random(len(frag))
    keep = frag[u >= 0.03]  # 3% deletions
    sub = rng.random(len(keep)) < 0.04
    keep = keep.copy()
    keep[sub] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                              int(sub.sum()))]
    ins = rng.random(len(keep)) < 0.03
    out = np.insert(keep, np.flatnonzero(ins),
                    np.frombuffer(b"ACGT", np.uint8)[
                        rng.integers(0, 4, int(ins.sum()))])
    return out.tobytes().decode()


def check_long(sc, d, card):
    from panmap_tpu.align.long_device import long_dp_device_batch
    from panmap_tpu.align.longread import (MAP_ONT, LongReadAligner,
                                           banded_dp_shifted)

    rng = np.random.default_rng(6)
    genome = d["genome"]
    al = LongReadAligner(genome, MAP_ONT)
    fronts = [al._chain_front(_ont_read(rng, genome, n))
              for n in sc["long_reads"]]
    items = [(f[0], f[1], f[2]) for f in fronts if f is not None]
    check(len(items) == len(fronts), "long reads failed to chain")
    t0 = time.perf_counter()
    dev = long_dp_device_batch(items, al.index.codes2, MAP_ONT)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    long_dp_device_batch(items, al.index.codes2, MAP_ONT)
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [banded_dp_shifted(q, al.index.codes2, a, b, MAP_ONT)
            for q, a, b in items]
    t_host = time.perf_counter() - t0
    same = sum(h == g for h, g in zip(host, dev))
    widths = [b - a + 1 for _, a, b in items]
    say(f"[c] long DP: {len(items)} ONT-like reads "
        f"{[len(q) for q, _, _ in items]} bp, bands {widths}: exact "
        f"{same}/{len(items)}; device {t_warm:.3f}s warm, {t_first:.2f}s "
        f"first call incl. compile; numpy {t_host:.2f}s [{card}]")
    check(same == len(items), "long DP differs from banded_dp_shifted")


def check_tally(sc):
    from panmap_tpu.genotype.caller import tally_columns_device

    rng = np.random.default_rng(7)
    E, ncol = sc["tally_entries"], 30000
    col = np.sort(rng.integers(0, ncol, E))
    q = rng.integers(4, 64, E)
    s = rng.integers(0, 2, E)
    b = rng.integers(0, 5, E)
    bcf, qs, adf, adr = tally_columns_device(col, q, s, b, ncol)
    ok = np.array_equal(bcf, np.bincount(col * 5 + b, minlength=ncol * 5)
                        .reshape(ncol, 5))
    v = b < 4
    ok &= np.array_equal(qs, np.bincount(col[v] * 4 + b[v], weights=q[v],
                                         minlength=ncol * 4).reshape(ncol, 4))
    for strand, got in ((0, adf), (1, adr)):
        m = v & (s == strand)
        ok &= np.array_equal(got, np.bincount(col[m] * 4 + b[m],
                                              minlength=ncol * 4)
                             .reshape(ncol, 4))
    say(f"[c] device tally: {E} pileup entries over {ncol} columns: "
        f"{'exact' if ok else 'MISMATCH'} against numpy bincounts")
    check(ok, "device tally differs from numpy")


def meta_inputs(d):
    """The mixture's reads, sketched as the meta driver sketches them."""
    from panmap_tpu.io import fastq
    from panmap_tpu.meta.engine import sketch_meta_reads_full

    midx = d["midx"]
    p = midx.params
    seqs = fastq.read_paired_for_placement(*d["meta_reads"])
    reads, _, _ = sketch_meta_reads_full(seqs, p.k, p.s, p.t, p.l, p.open)
    return reads


def _candidates(scorer_dev, host, top):
    """The top candidates by overlap coefficient (the driver's ranking,
    without its shared ranks)."""
    oc = scorer_dev.overlap_coefficients()
    kept = [n for n in range(len(oc)) if host.tree.keep[n]]
    return sorted(kept, key=lambda n: -oc[n])[:top]


def check_meta(sc, d, card):
    """Device meta scorer exact against the native host scorer; device f32
    EM against the host f64 EM."""
    from panmap_tpu.meta.engine import MetaScorer, run_squarem
    from panmap_tpu.meta.engine_tpu import TpuMetaScorer

    midx = d["midx"]
    reads = meta_inputs(d)
    host = MetaScorer(midx, reads)
    t0 = time.perf_counter()
    dev = TpuMetaScorer(midx, reads)
    cands = _candidates(dev, host, sc["top_oc"])
    mx_d, snap_d = dev.score_all(cands)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    mx_h, snap_h = host.score_all(cands)
    t_host = time.perf_counter() - t0
    same = np.array_equal(np.asarray(mx_d), np.asarray(mx_h)) and \
        np.array_equal(np.asarray(snap_d), np.asarray(snap_h))
    say(f"[c] meta scorer: {len(reads)} read sets x {len(cands)} candidates: "
        f"{'exact' if same else 'MISMATCH'} against the host scorer; device "
        f"incl. compile {t_dev:.2f}s, host {t_host:.2f}s [{card}]")
    check(same, "device meta scores differ from the host scorer")

    lens = np.array([len(r.hashes) for r in reads], np.int64)
    w = np.array([r.n_dup for r in reads], np.float64)
    w[np.asarray(mx_h) == 0] = 0.0
    names = [midx.node_ids[n] for n in cands]
    f64 = run_squarem(np.asarray(snap_h, np.uint16), lens, w, names,
                      backend="numpy", **EM_KW)
    _, snap_dev = dev.score_all(cands, snap_device=True)
    f32 = run_squarem(snap_dev, lens, w, names, **EM_KW)
    diff = _em_diff(f64, f32)
    say(f"[c] device EM vs host f64 EM: {len(f32.node_names)} columns, max "
        f"|diff| {diff:.3g} (tolerance {EM_TOL}) [{card}]")
    check(diff <= EM_TOL, f"EM differs by {diff}")


def _em_diff(a, b) -> float:
    pa = dict(zip(a.node_names, a.props))
    pb = dict(zip(b.node_names, b.props))
    check(set(pa) == set(pb), "EM column sets differ")
    return max((abs(pa[n] - pb[n]) for n in pa), default=0.0)


# ---------------------------------------------------------------- phase (d)
BAM_EXT = (".placement.tsv", ".ref.fa", ".vcf", ".consensus.fa", ".bam")


def run_single(d, out, extra, tag):
    from panmap_tpu.__main__ import build_parser, pipeline_config
    from panmap_tpu.pipeline import run_pipeline

    log = StageLog(tag)
    args = build_parser().parse_args(
        [d["panman"], *d["reads"], "-i", d["index"], "-o", out] + extra)
    run_pipeline(pipeline_config(args, out, log), d["tree"])
    return time.perf_counter() - log.t0, log


def _file_bytes(path):
    with open(path, "rb") as fh:
        raw = fh.read()
    if path.endswith(".bam"):
        return gzip.decompress(raw)
    if path.endswith(".consensus.fa"):  # the header names the output prefix
        return raw.split(b"\n", 1)[1]
    return raw


def compare_outputs(a, b, exts=BAM_EXT):
    bad = [e for e in exts if _file_bytes(a + e) != _file_bytes(b + e)]
    check(not bad, f"outputs differ: {bad}")


def phase_single(d, card, mesh="1"):
    """Device defaults against --host-place with the device off; returns
    (device wall s, host wall s)."""
    from panmap_tpu.align.batch import DEVICE_TOTALS
    from panmap_tpu.genotype.caller import TALLY_STATS
    from panmap_tpu.pipeline import _get_placer
    from panmap_tpu.utils.device import ENV

    work = d["work"]
    scored0, tally0 = DEVICE_TOTALS["scored"], TALLY_STATS["calls"]
    t_dev, _ = run_single(d, os.path.join(work, "dev"), ["--mesh", mesh],
                          "device")
    placer = _get_placer._placer
    st = dict(placer.stats)
    scored = DEVICE_TOTALS["scored"] - scored0
    tallies = TALLY_STATS["calls"] - tally0
    old = os.environ.get(ENV)
    os.environ[ENV] = "0"
    try:
        t_host, _ = run_single(d, os.path.join(work, "host"),
                               ["--mesh", mesh, "--host-place"], "host")
    finally:
        if old is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = old
    compare_outputs(os.path.join(work, "dev"), os.path.join(work, "host"))
    say(f"[d] outputs byte-equal, device vs host: {', '.join(BAM_EXT)} "
        f"(BAM decompressed, consensus without its header line)")
    say(f"[d] placement: {st['answered']} device answers, "
        f"{st['guard_trips']} guard trips, largest |f32-f64| "
        f"{st['max_abs_err']:.3g}; device DP windows scored {scored}; "
        f"device tally programs run {tallies}")
    check(st["answered"] >= 1 and st["guard_trips"] == 0,
          f"placement device leg did not answer cleanly: {st}")
    check(scored > 0, "the DP stage scored no window on the device")
    check(tallies > 0, "the device tally did not run")
    fn, args = placer.last_step
    mem = fn.lower(*args).compile().memory_analysis()
    say(f"[c] placement step memory_analysis: {mem}")
    return t_dev, t_host, placer


def check_truth(d):
    """The sample lands on its source genome and its SNPs are called."""
    work = d["work"]
    tsv = [line.rstrip("\n").split("\t") for line in
           open(os.path.join(work, "dev.placement.tsv"))][1:]
    hits = [f[0] for f in tsv if d["leaf"] in f[2].split(",")]
    check(hits, f"the source genome {d['leaf']} is in no metric's best set")
    called = {int(f[1]) - 1: (f[3], f[4].split(",")) for f in (
        line.split("\t") for line in open(os.path.join(work, "dev.vcf"))
        if not line.startswith("#"))}
    snps = [t for t in d["truth"] if len(t[1]) == len(t[2]) == 1]
    hit = sum(p in called and alt in called[p][1] for p, _, alt in snps)
    indels = [t for t in d["truth"] if t not in snps]
    # an indel may be left-shifted within a repeat
    ihit = sum(any(abs(q - p) <= 5 and len(r) != len(a[0])
                   for q, (r, a) in called.items()) for p, _, _ in indels)
    say(f"[d] truth: source genome {d['leaf']} in the best set of "
        f"{', '.join(hits)}; {hit}/{len(snps)} planted SNPs and "
        f"{ihit}/{len(indels)} planted indels called "
        f"({len(called)} variants against the placed node)")
    placed = open(os.path.join(work, "dev.ref.fa")).read().split("\n")[1]
    if placed == d["tree"].get_string(d["leaf"]):  # truth is in its coords
        check(hit >= 0.9 * len(snps), "planted SNPs not called")


# ---------------------------------------------------------------- phase (e)
def run_meta_cli(d, out, extra, tag):
    from panmap_tpu.__main__ import build_parser, meta_config
    from panmap_tpu.meta.driver import run_meta

    log = StageLog(tag)
    args = build_parser().parse_args(
        ["--meta", d["meta_panman"], *d["meta_reads"], "-o", out] + extra)
    rc = run_meta(meta_config(args, out, log), midx=d["midx"])
    check(rc == 0, f"run_meta {tag} returned {rc}")
    props = {}
    for line in open(out + ".mgsr.abundance.out"):
        names, p = line.rstrip("\n").split("\t")
        props[names] = float(p)
    return time.perf_counter() - log.t0, props


def clade_masses(dev: dict, host: dict, tree):
    """Both abundance tables summed over clades: groups joined when a node
    of one is the tree parent of a node of the other."""
    groups = sorted(set(dev) | set(host))
    group_of = {n: g for g in groups for n in g.split(",")}
    root = {g: g for g in groups}

    def find(g):
        while root[g] != g:
            g = root[g]
        return g

    for g in groups:
        for n in g.split(","):
            node = tree.all_nodes.get(n)
            par = group_of.get(node.parent.identifier) \
                if node is not None and node.parent is not None else None
            if par is not None and find(par) != find(g):
                root[find(g)] = find(par)
    out = []
    for table in (dev, host):
        mass = dict.fromkeys({find(g) for g in groups}, 0.0)
        for g, p in table.items():
            mass[find(g)] += p
        out.append(mass)
    return out


def _top(table: dict, n: int) -> set:
    return set(sorted(table, key=lambda k: -table[k])[:n])


def phase_meta(sc, d, card, mesh="1"):
    """--meta with the device scorer and f32 EM against --host-score
    --em-f64, run to the likelihood maximum (held per group) and at the CLI
    defaults (held per clade); returns {setting: (device s, host s)}."""
    work = d["work"]
    walls = {}
    n = len(MIX_PROPS)
    for setting, em_args in (("to the maximum", EM_ARGS),
                             ("CLI defaults", [])):
        common = ["--mesh", mesh, "--top-oc", str(sc["top_oc"])] + em_args
        tag = "max" if em_args else "default"
        t_dev, dev = run_meta_cli(d, os.path.join(work, f"meta_dev_{tag}"),
                                  common, f"meta-device {setting}")
        t_host, host = run_meta_cli(d, os.path.join(work, f"meta_host_{tag}"),
                                    common + ["--host-score", "--em-f64"],
                                    f"meta-host {setting}")
        walls[setting] = (t_dev, t_host)
        vals = np.array(list(dev.values()))
        check(np.isfinite(vals).all() and abs(vals.sum() - 1) < 1e-3,
              "abundances are not a distribution")
        diff = max(abs(dev.get(k, 0.0) - host.get(k, 0.0))
                   for k in set(dev) | set(host))
        cdev, chost = clade_masses(dev, host, d["meta_tree"])
        cdiff = max(abs(cdev[k] - chost[k]) for k in cdev)
        say(f"[e] {setting}: device vs host abundances, {len(dev)} vs "
            f"{len(host)} groups, max |diff| {diff:.3g} per group, "
            f"{cdiff:.3g} per clade ({len(cdev)} clades); tolerance {EM_TOL} "
            f"{'per group' if em_args else 'per clade'}; top {n} groups "
            f"identical: {_top(dev, n) == _top(host, n)}, top {n} clades "
            f"identical: {_top(cdev, n) == _top(chost, n)}")
        found = {h: sum(p for k, p in dev.items() if h in k.split(","))
                 for h in d["haps"]}
        say(f"[e] {setting}: truth " + ", ".join(
            f"{h} {t:.2f}->{found[h]:.4f}"
            for h, t in zip(d["haps"], MIX_PROPS)))
        if em_args:
            check(set(dev) == set(host), "abundance groups differ")
            check(diff <= EM_TOL, f"abundances differ by {diff}")
            check(_top(dev, n) == _top(host, n), "top haplotypes differ")
        else:
            check(cdiff <= EM_TOL, f"clade abundances differ by {cdiff}")
            check(_top(cdev, n) == _top(chost, n), "top clades differ")
    return walls


# ---------------------------------------------------------------- phase (f)
def phase_four(sc, d, card):
    """--mesh 4 placement, sharded meta scorer and sharded EM, each against
    its one-card result."""
    import jax

    from panmap_tpu.meta.engine import run_squarem
    from panmap_tpu.meta.engine_tpu import TpuMetaScorer
    from panmap_tpu.parallel.mesh import make_mesh

    check(len(jax.devices()) >= 4, "--four-cards needs four devices")
    work = d["work"]
    t1, _ = run_single(d, os.path.join(work, "m1"),
                       ["--mesh", "1", "--stop", "place"], "mesh1")
    t4, _ = run_single(d, os.path.join(work, "m4"),
                       ["--mesh", "4", "--stop", "place"], "mesh4")
    compare_outputs(os.path.join(work, "m1"), os.path.join(work, "m4"),
                    (".placement.tsv",))
    say(f"[f] placement --mesh 4 == --mesh 1 (placement.tsv byte-equal); "
        f"wall {t4:.2f}s vs {t1:.2f}s [{card}]")

    midx = d["midx"]
    reads = meta_inputs(d)
    one = TpuMetaScorer(midx, reads)
    from panmap_tpu.meta.engine import MetaScorer

    cands = _candidates(one, MetaScorer(midx, reads), sc["top_oc"])
    mesh = make_mesh(4)
    four = TpuMetaScorer(midx, reads, mesh=mesh)
    a, b = one.score_all(cands), four.score_all(cands)
    same = all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))
    say(f"[f] sharded meta scorer over 4 devices: "
        f"{'identical' if same else 'DIFFERENT'} scores")
    check(same, "sharded meta scores differ")
    lens = np.array([len(r.hashes) for r in reads], np.int64)
    w = np.array([r.n_dup for r in reads], np.float64)
    w[np.asarray(a[0]) == 0] = 0.0
    names = [midx.node_ids[n] for n in cands]
    _, s1 = one.score_all(cands, snap_device=True)
    _, s4 = four.score_all(cands, snap_device=True)
    e1 = run_squarem(s1, lens, w, names, **EM_KW)
    e4 = run_squarem(s4, lens, w, names, mesh=mesh, **EM_KW)
    diff = _em_diff(e1, e4)
    say(f"[f] sharded EM over 4 devices vs one: max |diff| {diff:.3g} "
        f"(tolerance {EM_TOL}; psum order differs) [{card}]")
    check(diff <= EM_TOL, f"sharded EM differs by {diff}")


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --mesh 4 phase, on four GPUs")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--workdir", default="",
                    help="where generated data and outputs go (default: a "
                         "temporary directory, removed at exit)")
    opts = ap.parse_args(argv)

    import jax

    import panmap_tpu
    from panmap_tpu.native import get_lib

    card = card_line()
    say(f"[a] jax {jax.__version__}; python {sys.version.split()[0]}")
    say(f"[a] card (nvidia-smi name, power.limit): {card}")
    platform = probe_platform()
    say(f"[a] JAX platform: {platform or 'none'}")
    if platform != "gpu":
        say("[a] no GPU: nothing to smoke-test")
        return 1
    say(f"[a] native C++ library loaded: {get_lib() is not None}")
    say(f"[a] compile cache: {panmap_tpu.compile_cache_dir()}")

    sc = dict(FULL)
    for k, (v, why) in CUTS.items():
        say(f"[cut] {k}: {sc[k]} -> {v} ({why})")
        sc[k] = v
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = opts.workdir or tmp
        os.makedirs(work, exist_ok=True)
        d = make_data(sc, opts.seed, work)  # host only: forks happen here

        devs = jax.devices()
        say(f"[a] jax.devices(): {devs}")
        if opts.four_cards:
            phase_four(sc, d, card)
        else:
            check_sw(sc, d, card)
            check_long(sc, d, card)
            check_tally(sc)
            check_meta(sc, d, card)
            t_dev, t_host, _ = phase_single(d, card)
            check_truth(d)
            say(f"[d] single-sample wall: device defaults {t_dev:.2f}s, "
                f"host {t_host:.2f}s [{card}]")
            for setting, (m_dev, m_host) in phase_meta(sc, d, card).items():
                say(f"[e] meta wall, {setting}: device {m_dev:.2f}s, "
                    f"host-score + em-f64 {m_host:.2f}s [{card}]")
    say(f"[done] all phases passed in {time.perf_counter() - t_all:.1f}s "
        f"[{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Fail as exc:
        say(f"[FAIL] {exc}")
        sys.exit(1)
