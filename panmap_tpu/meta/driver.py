"""Metagenomic (--meta) driver: abundance deconvolution pipeline.

Mirrors src/main.cpp runMetagenomic/runDeconvolution (:1192-1313): meta index
(cached next to the panman), read sketching + dust filter, overlap-coefficient
ranking, identical-node collapsing, per-read scoring, unmapped/low-parsimony
discards, SQUAREM EM rounds, abundance output with identical-group expansion.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from ..index.builder import IndexParams
from ..io import fastq
from ..io.panman import load_panman
from .engine import MetaScorer, run_squarem, sketch_meta_reads
from .index import (
    MetaIndexArrays,
    build_meta_index,
    load_meta_index,
    read_meta_params,
    save_meta_index,
)


@dataclass
class MetaConfig:
    panman: str = ""
    reads1: str = ""
    reads2: str = ""
    output: str = "sample"
    index_path: str = ""  # load a pre-built .ptmidx from this path
    index_out: str = ""  # write the built meta index here (main.cpp --index-out)
    k: int = 19
    s: int = 8
    t: int = 0
    l: int = 3
    open: bool = False
    em_convergence_threshold: float = 1e-5
    em_delta_threshold: float = 0.0
    em_maximum_rounds: int = 5
    em_maximum_iterations: int = 1000
    top_oc: int = 1000
    dust: float = 100.0
    discard: float = 0.0
    mask_reads: int = 0
    mask_seeds: int = 0
    mask_reads_rf: float = 0.0
    mask_seeds_rf: float = 0.0
    amplicon_depth: str = ""
    mask_read_ends: int = 0
    pseudochain: bool = False
    filter_and_assign: bool = False
    batch_size: int = 1_000_000  # filter-and-assign read-stream batch
    host_score: bool = False  # --host-score: threaded native CPU scoring
    em_f64: bool = False  # --em-f64: host float64 EM (reference precision)
    mesh: int = 0  # --mesh: shard the EM's reads over N devices (0 = auto)
    taxonomy_path: str = ""
    taxonomic_rank: str = "Family"
    max_taxon_number: int = 1
    ambiguous_score_threshold: int = 0
    ambiguous_score_threshold_ratio: float = 0.0
    breadth_ratio: bool = False
    jplace: bool = False
    align_reads: bool = False
    min_num_align: int = 10
    write_ocranks: bool = False
    write_read_scores_unfiltered: bool = False
    write_read_scores_filtered: bool = False
    leaves_only: bool = False
    em_candidates: str = ""  # dev: file of node ids; restrict the EM to them
    threads: int = 0
    stop: str = ""
    log: object = print


def ensure_meta_index(cfg: MetaConfig, tree=None):
    path = cfg.index_path or cfg.index_out or cfg.panman + ".ptmidx.npz"
    want = dict(k=cfg.k, s=cfg.s, t=cfg.t, l=cfg.l, open=cfg.open)
    if os.path.exists(path):
        try:
            hdr = read_meta_params(path)
            if (all(hdr.get(kk) == vv for kk, vv in want.items())
                    and os.path.getmtime(path) >= os.path.getmtime(cfg.panman)):
                return load_meta_index(path), tree
        except Exception:
            pass
    if tree is None:
        tree = load_panman(cfg.panman)
    t0 = time.time()
    midx = build_meta_index(
        tree, IndexParams(k=cfg.k, s=cfg.s, t=cfg.t, l=cfg.l, open=cfg.open),
        workers=cfg.threads or (os.cpu_count() or 1))
    cfg.log(f"[meta-index] built in {time.time()-t0:.1f}s "
            f"({len(midx.delta_seed)} deltas, {len(midx.seed_hash)} seeds)")
    try:
        save_meta_index(path, midx)
    except OSError:
        cfg.log(f"[meta-index] warning: could not cache at {path}")
    return midx, tree


def _resolve_meta_mesh(cfg):
    """--mesh for the meta path (same semantics as the placement pipeline:
    0 = auto when >1 local device, 1 = off, N = first N devices)."""
    want_mesh = getattr(cfg, "mesh", 0)
    if want_mesh == 1:
        return None
    import jax

    n_avail = len(jax.devices())
    want = want_mesh if want_mesh > 0 else (n_avail if n_avail > 1 else 1)
    if want <= 1:
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh(min(want, n_avail))


def run_meta(cfg: MetaConfig, midx: MetaIndexArrays | None = None) -> int:
    if midx is None:
        midx, tree = ensure_meta_index(cfg)
    if cfg.stop == "index" or not cfg.reads1:
        return 0

    if cfg.filter_and_assign:
        from .assign import run_filter_and_assign

        return run_filter_and_assign(cfg, midx)

    p = midx.params
    masking = (cfg.mask_reads or cfg.mask_seeds or cfg.mask_reads_rf
               or cfg.mask_seeds_rf or cfg.amplicon_depth or cfg.mask_read_ends)
    if masking:
        from .engine import sketch_meta_reads_grouped

        names, seqs, _ = fastq.read_full(cfg.reads1)
        if cfg.reads2:
            n2, s2, _ = fastq.read_full(cfg.reads2)
            names += n2
            seqs += s2
        reads, dup_index, n_dust, n_masked = sketch_meta_reads_grouped(
            seqs, names, p, cfg)
        cfg.log(f"[meta] {len(seqs)} reads -> {len(reads)} unique seedmer sets"
                f" ({n_dust} low-complexity, {n_masked} masked)")
    else:
        from .engine import sketch_meta_reads_full

        seqs = fastq.read_paired_for_placement(cfg.reads1, cfg.reads2 or None)
        reads, dup_index, n_dust = sketch_meta_reads_full(
            seqs, p.k, p.s, p.t, p.l, p.open, dust_threshold=cfg.dust)
        cfg.log(f"[meta] {len(seqs)} reads -> {len(reads)} unique seedmer sets "
                f"({n_dust} low-complexity discarded)")

    scorer = MetaScorer(midx, reads)
    want_scores_tsv = getattr(cfg, "write_read_scores_unfiltered", False)
    mesh = _resolve_meta_mesh(cfg)
    # large read sets: event-based batched scorer (identical results; the
    # python DFS is kept for pseudochain and node-score collection)
    fast = None
    # --host-score: skip the device scorer and use the threaded native host
    # core (the reference the device scorer is checked against)
    if (not cfg.pseudochain and not want_scores_tsv and len(reads) >= 2000
            and not getattr(cfg, "host_score", False)):
        from .engine_tpu import TpuMetaScorer

        t0 = time.time()
        fast = TpuMetaScorer(midx, reads, mesh=mesh)
        cfg.log(f"[meta] presence events built in {time.time()-t0:.1f}s "
                f"({len(fast.ev_pos)} events)")
    if fast is not None:
        oc_arr = fast.overlap_coefficients()
        oc = {n: float(oc_arr[n]) for n in range(len(midx.node_ids))}
    else:
        oc = scorer.overlap_coefficients()
    if getattr(cfg, "write_ocranks", False):
        # shared-rank TSV (main.cpp:430-445 writeOCRanks)
        path = cfg.output + ".overlapCoefficients.tsv"
        with open(path, "w") as fh:
            rank = 0
            prev_oc = None
            for n, v in sorted(oc.items(), key=lambda kv: -kv[1]):
                if prev_oc is not None and v != prev_oc:
                    rank += 1
                prev_oc = v
                fh.write(f"{midx.node_ids[n]}\t{v:.6f}\t{rank}\n")
        cfg.log(f"[meta] wrote {path}")
    # shared-rank assignment over surviving nodes (mgsr.cpp:141-154)
    kept_nodes = [n for n in oc if scorer.tree.keep[n]]
    if cfg.leaves_only:
        # --em-leaves-only (mgsr.cpp:8018): candidates restricted to leaves
        n_nodes = len(midx.node_ids)
        has_child = np.zeros(n_nodes, dtype=bool)
        has_child[midx.parent_index[1:]] = True
        kept_nodes = [n for n in kept_nodes if not has_child[n]]
    kept_sorted = sorted(kept_nodes, key=lambda n: -oc[n])
    candidates = []
    rank = 0
    prev = None
    for n in kept_sorted:
        if prev is None or oc[n] != prev:
            prev = oc[n]
            rank += 1
            if rank > cfg.top_oc:
                break
        candidates.append(n)
    cfg.log(f"[meta] {len(candidates)} candidate nodes from overlap coefficients")
    if cfg.em_candidates:
        # dev restriction (--em-candidates): pin the EM's haplotype columns
        # to an explicit node list — used by the demo-2 golden surrogate gate
        # (tools/check_examples.sh) to measure EM precision on the golden
        # haplotype set independent of candidate-selection ambiguity
        try:
            with open(cfg.em_candidates) as fh:
                want = [ln.split("\t")[0].strip() for ln in fh if ln.strip()]
        except OSError as exc:
            cfg.log(f"[meta] error: --em-candidates unreadable: {exc}")
            return 1
        want = list(dict.fromkeys(want))  # dedup, order-preserving
        id_of = {nm: i for i, nm in enumerate(midx.node_ids)}
        missing = [nm for nm in want if nm not in id_of]
        if missing:
            cfg.log(f"[meta] error: --em-candidates names not in the panman: "
                    f"{missing[:3]}")
            return 1
        candidates = [id_of[nm] for nm in want]
        cfg.log(f"[meta] EM candidates pinned to {len(candidates)} nodes "
                f"(--em-candidates)")

    t0 = time.time()
    score_fn = (scorer.score_all_pseudo if cfg.pseudochain
                else scorer.score_all)
    col_map = None
    if fast is not None:
        # snap stays on device in bucketed tile layout; run_squarem consumes
        # it there (no matrix round-trip, no per-workload program shapes)
        max_score, snap, col_map = fast.score_all(candidates, tiled=True)
    elif want_scores_tsv:
        max_score, snap, node_scores = score_fn(candidates,
                                                collect_node_scores=True)
    else:
        max_score, snap = score_fn(candidates)
    cfg.log(f"[meta] scored {len(reads)} read sets over the tree in {time.time()-t0:.1f}s")

    if want_scores_tsv:
        from .engine import count_epp, write_read_scores_tsv

        epp = count_epp(node_scores, max_score,
                        midx.parent_index.astype(np.int64), scorer.tree.keep,
                        len(reads))
        path = cfg.output + ".read_scores_info.unfiltered.tsv"
        write_read_scores_tsv(path, reads, dup_index, max_score, epp)
        cfg.log(f"[meta] wrote {path}")

    read_lens = np.array([len(r.hashes) for r in reads], dtype=np.int64)
    weights = np.array([r.n_dup for r in reads], dtype=np.float64)
    eff_max = max_score.copy()
    n_unmapped = int((eff_max == 0).sum())
    low = eff_max < (read_lens * cfg.discard)
    eff_max[low] = 0
    weights[eff_max == 0] = 0.0
    cfg.log(f"[meta] {n_unmapped} unmapped, {int(low.sum())} discarded by "
            f"--discard {cfg.discard}")
    if (weights > 0).sum() == 0:
        cfg.log("[meta] no reads remain for EM")
        return 0

    cand_names = [midx.node_ids[n] for n in candidates]
    t0 = time.time()
    if getattr(cfg, "em_f64", False):
        # --em-f64: the reference's precision envelope (f64 Eigen with Kahan
        # sums, mgsr.cpp:4341-4443) via the host numpy-f64 SQUAREM — bounds
        # any f32 drift risk on divergent mixtures at the cost of host time
        if col_map is not None:  # device tiled snap [Rpad, cols] -> [M, R]
            S_np = np.asarray(snap)[: len(reads)][:, col_map].T.copy()
        else:
            S_np = np.asarray(snap)
        res = run_squarem(
            S_np.astype(np.uint16), read_lens, weights, cand_names,
            eta=cfg.em_convergence_threshold,
            max_change_threshold=cfg.em_delta_threshold,
            max_iterations=cfg.em_maximum_iterations,
            max_rounds=cfg.em_maximum_rounds,
            backend="numpy",
        )
    else:
        res = run_squarem(
            snap, read_lens, weights, cand_names,
            eta=cfg.em_convergence_threshold,
            max_change_threshold=cfg.em_delta_threshold,
            max_iterations=cfg.em_maximum_iterations,
            max_rounds=cfg.em_maximum_rounds,
            col_map=col_map,
            prefer_cpu=getattr(cfg, "host_score", False),
            mesh=mesh,
        )
    em_dt = time.time() - t0
    if res.n_iterations:
        cfg.log(f"[meta] EM: {res.n_iterations} SQUAREM steps in {em_dt:.1f}s "
                f"({res.n_iterations / max(em_dt, 1e-9):.0f} iters/s)")

    # identical-member expansion: collapsed-away nodes ride with their keeper
    id_to_index = {nm: i for i, nm in enumerate(midx.node_ids)}
    members_of: dict = {}
    for keeper, absorbed in scorer.tree.identical_members.items():
        members_of[midx.node_ids[keeper]] = [midx.node_ids[a] for a in absorbed]

    order = np.argsort(-res.props)
    out_path = cfg.output + ".mgsr.abundance.out"
    with open(out_path, "w") as fh:
        for i in order:
            name = res.node_names[i]
            parts = [name] + members_of.get(name, [])
            for g in res.identical_groups.get(name, []):
                parts.append(g)
                parts.extend(members_of.get(g, []))
            fh.write(",".join(parts) + f"\t{res.props[i]:.5f}\n")
    cfg.log(f"[meta] wrote {out_path}")
    return 0
