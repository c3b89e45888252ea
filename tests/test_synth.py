"""The seeded PanMAN generator (panmap_tpu/synth.py)."""

import numpy as np
import pytest

from panmap_tpu import synth
from panmap_tpu.io.panman import NUC_FROM_CODE, parse_newick


def _expected_sequence(tree, name):
    """Replay the path's mutations onto the root consensus by hand."""
    seq = [NUC_FROM_CODE[b.consensus_codes].copy() for b in tree.blocks]
    for node in tree.path_from_root(name):
        for blk, pos, gap, packed in zip(node.nm_block.tolist(),
                                         node.nm_pos.tolist(),
                                         node.nm_gap.tolist(),
                                         node.nm_packed.tolist()):
            assert gap == -1
            n = (packed & 0xFF) >> 4
            for i in range(n):
                seq[blk][pos + i] = NUC_FROM_CODE[
                    (packed >> (8 + 4 * (n - 1 - i))) & 0xF]
    return b"".join(s.tobytes() for s in seq).replace(b"-", b"").decode()


@pytest.fixture(scope="module")
def tree():
    return synth.make_tree(5, 40, 4000, block_len=700)


def test_same_seed_same_tree(tree):
    again = synth.make_tree(5, 40, 4000, block_len=700)
    assert again.newick == tree.newick
    for a, b in zip(tree.dfs_order, again.dfs_order):
        assert a.identifier == b.identifier
        for col in ("nm_block", "nm_pos", "nm_gap", "nm_packed"):
            np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    other = synth.make_tree(6, 40, 4000, block_len=700)
    assert any(len(a.nm_pos) != len(b.nm_pos) or
               not np.array_equal(a.nm_pos, b.nm_pos)
               for a, b in zip(tree.dfs_order, other.dfs_order))


def test_get_string_matches_applied_mutations(tree):
    names = synth.leaf_names(tree)
    assert len(names) == 40 and len(tree.dfs_order) == 79
    for name in names[:10] + [tree.dfs_order[3].identifier]:
        assert tree.get_string(name) == _expected_sequence(tree, name)


def test_tree_structure(tree):
    root = tree.root
    assert len(root.block_mutations) == len(tree.blocks)
    assert all(bm.is_insertion for bm in root.block_mutations)
    quiet = [n for n in tree.dfs_order[1:] if len(n.nm_pos) == 0]
    assert quiet, "no node identical to its parent"
    assert tree.get_string(quiet[0].identifier) == \
        tree.get_string(quiet[0].parent.identifier)
    # the newick string parses back to the same preorder
    stack, order = [parse_newick(tree.newick)], []
    while stack:
        n = stack.pop()
        order.append(n.identifier)
        stack.extend(reversed(n.children))
    assert order == [n.identifier for n in tree.dfs_order]
    assert [n.dfs_index for n in tree.dfs_order] == list(range(79))


def test_index_builds_on_generated_tree(tree):
    from panmap_tpu.index.builder import IndexParams, build_index

    idx = build_index(tree, IndexParams(), workers=1)
    assert len(idx.node_ids) == 79 and len(idx.seed_hashes) > 0
    assert idx.identical_to_parent.any()


def test_sample_genome_truth(tree):
    leaf = synth.leaf_names(tree)[0]
    ref = tree.get_string(leaf)
    seq, truth = synth.sample_genome(tree, leaf, 3, 9, n_indels=2)
    assert len(truth) == 5
    # rebuild the sample from the leaf and the VCF-style truth
    out, last = [], 0
    for pos, r, a in truth:
        assert ref[pos:pos + len(r)] == r
        out.append(ref[last:pos])
        out.append(a)
        last = pos + len(r)
    out.append(ref[last:])
    assert "".join(out) == seq


def test_simulate_pairs_are_fragments():
    rng = np.random.default_rng(0)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    r1, r2 = synth.simulate_pairs(seq, 50, 4, err=0.0)
    assert r1.shape == r2.shape == (50, 150)
    rc = seq[::-1].translate(str.maketrans("ACGT", "TGCA"))
    for a, b in zip(r1, r2):
        assert a.tobytes().decode() in seq
        assert b.tobytes().decode() in rc
    again = synth.simulate_pairs(seq, 50, 4, err=0.0)
    np.testing.assert_array_equal(again[0], r1)


def test_mixture_and_fastq(tmp_path):
    from panmap_tpu.io import fastq

    seqs = ["A" * 1000, "C" * 1000]
    r1, r2 = synth.mixture_pairs(seqs, (0.75, 0.25), 40, 1, err=0.0)
    assert len(r1) == 40
    assert sum(r.tobytes().startswith(b"A") for r in r1) == 30
    p1, p2 = synth.write_pairs(str(tmp_path / "mix"), r1, r2)
    names, reads, quals = fastq.read_full(p1)
    assert len(reads) == 40 and len(reads[0]) == 150
    assert set(quals[0]) == {"I"}
