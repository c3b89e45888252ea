"""Seeded PanMAN trees and reads, generated in memory.

A pangenome for tests, smoke runs and benchmarks where no .panman file is at
hand: ``make_tree`` builds a ``PanmanTree`` (io/panman.py) directly, with the
structure the reader produces from a real file:

 - the root genome is cut into consensus blocks, which the root switches on
   with block insertions;
 - the topology is a random binary tree (a Yule process: a uniformly chosen
   leaf splits in two), so ``n_leaves`` genomes give 2 n_leaves - 1 nodes;
 - every other node carries SNP and deletion mutations in the ``nm_*``
   columns, and a share of the nodes carry none (identical to their parent).

``simulate_pairs`` draws paired-end reads with substitution errors from a
sequence.  ``sample_genome`` plants known SNPs into a leaf's sequence (the
single-sample truth) and ``mixture_pairs`` draws reads from several genomes
at given proportions (the --meta truth).  Everything is drawn from one
``numpy.random.Generator`` seed, so the same arguments give the same output.
"""

from __future__ import annotations

import os

import numpy as np

from .io.panman import Block, BlockMutation, PanmanNode, PanmanTree

ONE_HOT = np.array([1, 2, 4, 8], np.uint8)  # A C G T as panman nucleotide codes
ACGT = np.frombuffer(b"ACGT", np.uint8)
ND, NSNP = 1, 3  # panman NucMutationType: deletion, SNP


def _packed(codes, mut_type: int) -> int:
    """nm_packed word: mutInfo byte (length << 4 | type) + code nibbles,
    first base in the highest nibble (io/panman.py decodes it so)."""
    n = len(codes)
    word = (n << 4) | mut_type
    for i, c in enumerate(codes):
        word |= int(c) << (8 + 4 * (n - 1 - i))
    return word


def make_tree(seed: int, n_leaves: int, genome_len: int,
              block_len: int = 1000, snps_per_node: float = 3.0,
              dels_per_node: float = 0.2, identical_frac: float = 0.1,
              max_del: int = 6) -> PanmanTree:
    """A random PanMAN tree of ``n_leaves`` genomes of about ``genome_len``
    bases (see the module docstring)."""
    rng = np.random.default_rng(seed)
    root_codes = ONE_HOT[rng.integers(0, 4, genome_len)]
    starts = np.arange(0, genome_len, block_len)
    tree = PanmanTree()
    tree.blocks = [Block(block_id=b, consensus_codes=root_codes[s:s + block_len])
                   for b, s in enumerate(starts.tolist())]
    blens = np.array([len(b.consensus_codes) for b in tree.blocks], np.int64)

    # Yule topology: children[i] of node i; node 0 is the root
    n_nodes = 2 * n_leaves - 1
    children = [[] for _ in range(n_nodes)]
    leaves = [0]
    nxt = 1
    while len(leaves) < n_leaves:
        j = int(rng.integers(0, len(leaves)))
        parent = leaves[j]
        children[parent] = [nxt, nxt + 1]
        leaves[j] = nxt
        leaves.append(nxt + 1)
        nxt += 2
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[leaves] = True
    names = [f"SYN{i:06d}" if is_leaf[i] else f"node_{i + 1}"
             for i in range(n_nodes)]

    nodes = [PanmanNode(names[i]) for i in range(n_nodes)]
    for i, ch in enumerate(children):
        nodes[i].children = [nodes[c] for c in ch]
        for c in ch:
            nodes[c].parent = nodes[i]
            nodes[c].branch_length = 1.0
    root = nodes[0]
    root.block_mutations = [BlockMutation(b, True, False)
                            for b in range(len(tree.blocks))]

    # per-node mutations, drawn in bulk: node -> (block, pos, packed) rows
    n_snp = rng.poisson(snps_per_node, n_nodes)
    n_del = rng.poisson(dels_per_node, n_nodes)
    quiet = rng.random(n_nodes) < identical_frac
    n_snp[0] = n_del[0] = 0
    n_snp[quiet] = 0
    n_del[quiet] = 0
    tot_snp, tot_del = int(n_snp.sum()), int(n_del.sum())
    snp_pos = rng.integers(0, genome_len, tot_snp)
    snp_alt = (np.searchsorted(ONE_HOT, root_codes[snp_pos])
               + rng.integers(1, 4, tot_snp)) % 4
    del_len = rng.integers(1, max_del + 1, tot_del)
    del_pos = rng.integers(0, genome_len, tot_del)
    snp_off = np.concatenate(([0], np.cumsum(n_snp)))
    del_off = np.concatenate(([0], np.cumsum(n_del)))
    empty = (np.empty(0, np.int64), np.empty(0, np.int32),
             np.empty(0, np.int32), np.empty(0, np.uint32))
    for i in range(1, n_nodes):
        a, b = snp_off[i], snp_off[i + 1]
        c, d = del_off[i], del_off[i + 1]
        if a == b and c == d:
            nodes[i].set_nuc_mutation_arrays(*empty)
            continue
        gpos = np.concatenate([snp_pos[a:b], del_pos[c:d]])
        blk = gpos // block_len
        pos = gpos % block_len
        # a deletion stays inside its block
        dl = np.minimum(del_len[c:d], blens[blk[b - a:]] - pos[b - a:])
        packed = [_packed((ONE_HOT[x],), NSNP) for x in snp_alt[a:b].tolist()]
        packed += [_packed((0,) * n, ND) for n in dl.tolist()]
        order = np.argsort(gpos, kind="stable")
        nodes[i].set_nuc_mutation_arrays(
            blk[order].astype(np.int64), pos[order].astype(np.int32),
            np.full(len(order), -1, np.int32),
            np.asarray(packed, np.uint32)[order])

    # preorder DFS (the reader's node order) and the newick string
    order, stack = [], [root]
    while stack:
        node = stack.pop()
        node.dfs_index = len(order)
        order.append(node)
        tree.all_nodes[node.identifier] = node
        stack.extend(reversed(node.children))
    tree.root = root
    tree.dfs_order = order
    tree.newick = _newick(root)
    return tree


def _newick(root: PanmanNode) -> str:
    """Newick text of the tree (iterative: trees are deep)."""
    out = []

    def label(n):
        return n.identifier + (f":{n.branch_length:g}"
                               if n.parent is not None else "")

    stack = [(root, 0)]
    while stack:
        n, k = stack.pop()
        if not n.children:
            out.append(label(n))
        elif k < len(n.children):
            out.append("(" if k == 0 else ",")
            stack.append((n, k + 1))
            stack.append((n.children[k], 0))
        else:
            out.append(")" + label(n))
    return "".join(out) + ";"


def leaf_names(tree: PanmanTree) -> list:
    return [n.identifier for n in tree.dfs_order if not n.children]


def sample_genome(tree: PanmanTree, leaf: str, n_snps: int, seed: int,
                  n_indels: int = 0, max_indel: int = 10):
    """The sequence of ``leaf`` with ``n_snps`` planted SNPs and
    ``n_indels`` planted insertions or deletions of 1..max_indel bases, at
    least 500 bases apart.  Returns (sequence, truth) where truth lists
    (0-based position in the leaf, ref allele, alt allele) VCF-style: an
    indel's alleles start with the base before it."""
    rng = np.random.default_rng(seed)
    ref = np.frombuffer(tree.get_string(leaf).encode(), np.uint8)
    n = n_snps + n_indels
    slots = rng.choice(np.arange(1, (len(ref) - 600) // 500), n,
                       replace=False) * 500 + rng.integers(0, 100, n)
    kinds = rng.permutation(np.r_[np.zeros(n_snps, int), np.ones(n_indels,
                                                                 int)])
    parts, truth, last = [], [], 0
    for p, kind in sorted(zip(slots.tolist(), kinds.tolist())):
        parts.append(ref[last:p])
        base = ref[p]
        if kind == 0:
            alt = ACGT[(int(np.searchsorted(ACGT, base)) + int(
                rng.integers(1, 4))) % 4] if base in ACGT else ACGT[0]
            parts.append(np.array([alt], np.uint8))
            truth.append((p, chr(base), chr(alt)))
            last = p + 1
        elif rng.random() < 0.5:  # deletion of ref[p:p+k]
            k = int(rng.integers(1, max_indel + 1))
            truth.append((p - 1, ref[p - 1:p + k].tobytes().decode(),
                          chr(ref[p - 1])))
            last = p + k
        else:  # insertion before ref[p]
            ins = ACGT[rng.integers(0, 4, int(rng.integers(1,
                                                           max_indel + 1)))]
            parts.append(ins)
            truth.append((p - 1, chr(ref[p - 1]),
                          chr(ref[p - 1]) + ins.tobytes().decode()))
            last = p
    parts.append(ref[last:])
    return np.concatenate(parts).tobytes().decode(), truth


_RC = np.full(256, ord("N"), np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _RC[_a] = _b


def simulate_pairs(seq: str, n_pairs: int, seed: int, read_len: int = 150,
                   insert_mean: float = 350.0, insert_sd: float = 50.0,
                   err: float = 0.001):
    """Paired-end reads from ``seq``: uniform fragment starts, normal insert
    sizes, substitution errors at rate ``err``.  Returns (r1, r2) as
    [n_pairs, read_len] uint8 ASCII arrays, R2 reverse-complemented as a
    sequencer reports it."""
    rng = np.random.default_rng(seed)
    s = np.frombuffer(seq.encode(), np.uint8)
    L = len(s)
    ins = np.clip(np.rint(rng.normal(insert_mean, insert_sd, n_pairs)),
                  read_len + 10, L).astype(np.int64)
    start = (rng.random(n_pairs) * (L - ins + 1)).astype(np.int64)
    col = np.arange(read_len)
    r1 = s[start[:, None] + col]
    r2 = _RC[s[(start + ins - 1)[:, None] - col]]
    for r in (r1, r2):
        hit = rng.random(r.shape) < err
        alt = ACGT[(np.searchsorted(ACGT, r[hit]) + rng.integers(
            1, 4, int(hit.sum()))) % 4]
        r[hit] = np.where(np.isin(r[hit], ACGT), alt, r[hit])
    return r1, r2


def mixture_pairs(seqs: list, props, n_pairs: int, seed: int, **kw):
    """Reads from several genomes: genome i contributes round(props[i] *
    n_pairs) pairs.  Returns (r1, r2) like simulate_pairs."""
    counts = np.rint(np.asarray(props, float) * n_pairs).astype(int)
    parts = [simulate_pairs(s, int(c), seed + 1 + i, **kw)
             for i, (s, c) in enumerate(zip(seqs, counts)) if c > 0]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def write_fastq(path: str, reads: np.ndarray, prefix: str = "r",
                suffix: str = "") -> None:
    """[n, L] ASCII read array -> FASTQ with constant Q40 qualities."""
    n, L = reads.shape
    qual = b"I" * L
    with open(path, "wb") as fh:
        for i in range(n):
            fh.write(b"@%s%d%s\n" % (prefix.encode(), i, suffix.encode()))
            fh.write(reads[i].tobytes())
            fh.write(b"\n+\n" + qual + b"\n")


def write_pairs(prefix: str, r1: np.ndarray, r2: np.ndarray):
    """Write <prefix>_R1.fastq / <prefix>_R2.fastq; returns both paths."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    p1, p2 = prefix + "_R1.fastq", prefix + "_R2.fastq"
    write_fastq(p1, r1, suffix="/1")
    write_fastq(p2, r2, suffix="/2")
    return p1, p2
