"""panmap-tpu: pangenome placement, alignment, and genotyping on JAX.

A from-scratch JAX/XLA re-design of the capabilities of amkram/panmap:
syncmer/k-min-mer seeding, a mutation-aware seed-delta index over the PanMAN
tree, per-node placement scoring, seed-chain-extend alignment, pileup
genotyping with a tree-derived substitution-spectrum prior, and the
metagenomic (mgsr) read-scoring + EM haplotype-abundance solver.
"""

__version__ = "0.1.0"


def _tune_host_memory():
    """Disable numpy's MADV_HUGEPAGE on large buffers (must run before numpy
    is first imported).  On VMs with synchronous THP compaction, every fresh
    huge-page fault costs ~100ms+, which made large one-shot numpy
    allocations (np.empty + first write) run at ~10 MB/s instead of ~2 GB/s —
    a 10-30x slowdown of every host-side array stage.  Override by setting
    NUMPY_MADVISE_HUGEPAGE yourself."""
    import os
    import sys

    if "numpy" not in sys.modules:
        os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    elif os.environ.get("NUMPY_MADVISE_HUGEPAGE") is None:
        # numpy already imported (e.g. by sitecustomize) — runtime switch
        try:
            try:
                from numpy._core import multiarray as _ma
            except ImportError:  # numpy < 2
                from numpy.core import multiarray as _ma
            _ma._set_madvise_hugepage(False)
        except Exception:
            pass
    # keep large freed buffers on the heap instead of returning them to the
    # OS (re-faulting them back in is the expensive part)
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_host_memory()


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    JAX_COMPILATION_CACHE_DIR when it is set, otherwise the fixed directory
    .cache/jax of this checkout (a fixed path, so later processes hit it)."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".cache", "jax")


def _enable_compile_cache():
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()
