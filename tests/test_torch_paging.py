"""The port's paging bookkeeping and the paged serving model against the JAX
package.

* The reference's random-walk harness (``tests/test_paging_properties.py``:
  seeded alloc / free / CoW fork / prefix adopt / trie register / spill /
  restore sequences, every invariant checked after every operation against
  an independent ownership count) run against the port's
  ``serving/paging.py``: the harness's source is loaded with its import of
  the reference module pointed at the port's.
* Lockstep: the same seeded operation sequences through both modules, with
  identical page ids, refcounts, free lists, high-watermarks, request
  tables and trie statistics required after every operation.
* ``serving_paged_peak_bytes`` / ``serving_paged_fits`` equal to the
  reference's, and ``ServingGuard.admission_escalation`` for all four flag
  pairs.

Every compared quantity is an integer or an fp64 byte count: no tolerance.
"""

import dataclasses
import types
from pathlib import Path

import pytest

pytest.importorskip("jax")

from repro.configs import registry  # noqa: E402
from repro.configs.base import GPU_64G  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.runtime.guard import ServingGuard as JGuard  # noqa: E402
from repro_torch.configs import H100_80G, get_config  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.runtime.guard import ServingGuard as TGuard  # noqa: E402

HARNESS = Path(__file__).with_name("test_paging_properties.py")
REF_IMPORT = "from repro.serving.paging import"


def _harness(paging_module: str) -> types.ModuleType:
    """The reference's property harness bound to ``paging_module``."""
    src = HARNESS.read_text()
    assert src.count(REF_IMPORT) == 1
    mod = types.ModuleType(f"paging_harness_{paging_module.replace('.', '_')}")
    exec(compile(src.replace(REF_IMPORT, f"from {paging_module} import"),
                 str(HARNESS), "exec"), mod.__dict__)
    return mod


REF = _harness("repro.serving.paging")
PORT = _harness("repro_torch.serving.paging")


def test_harness_is_bound_to_the_port():
    assert PORT.PageAllocator.__module__ == "repro_torch.serving.paging"
    assert REF.PageAllocator.__module__ == "repro.serving.paging"


# ---------------------------------------------------------------------------
# the reference's walks and edge cases, on the port's module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_allocator_random_walk(seed):
    ops_seq = PORT._gen_ops(seed, n_ops=150)
    try:
        PORT._replay(ops_seq)
    except (AssertionError, PORT.AllocatorCorruption) as exc:
        minimal = PORT._shrink(ops_seq)
        pytest.fail(f"invariant violated: {exc}\nminimal sequence "
                    f"({len(minimal)} ops): {minimal}")


@pytest.mark.parametrize("seed", range(6))
def test_trie_random_walk(seed):
    d = PORT.TrieDriver()
    for op in PORT._gen_trie_ops(seed, n_ops=120):
        d.apply(op)
        d.check()
    d.teardown()


@pytest.mark.parametrize("case", ["test_allocator_misuse_is_corruption",
                                  "test_allocator_exhaustion_and_hwm",
                                  "test_cow_refcounts_hit_zero_exactly_at_release",
                                  "test_worst_case_bytes_reservation",
                                  "test_group_block_math",
                                  "test_prefix_align_is_lcm"])
def test_reference_edge_case_on_the_port(case):
    getattr(PORT, case)()


# ---------------------------------------------------------------------------
# lockstep: both modules, one operation sequence, identical state
# ---------------------------------------------------------------------------

def _tables(rp) -> tuple:
    return (sorted((repr(g), list(t)) for g, t in rp.tables.items()),
            sorted((repr(g), sorted(b)) for g, b in rp.shared.items()),
            rp.state_block, rp.private_bytes)


def _trie(trie) -> list:
    out = []

    def walk(level, depth):
        for key in sorted(level):
            node = level[key]
            out.append((depth, key, sorted((repr(g), p) for g, p in
                                           node.pages.items()),
                        node.last_used))
            walk(node.children, depth + 1)
    walk(trie.root, 0)
    return out


def _state(d) -> dict:
    state = {
        "spaces": {repr(k): (list(sp.free), dict(sp.ref), sp.hwm, sp.total)
                   for k, sp in d.alloc.spaces.items()},
        "allocated_bytes": d.alloc.allocated_bytes(),
        "hwm_bytes": d.alloc.hwm_bytes(),
        "requests": {rid: _tables(rp) for rid, rp in d.requests.items()},
        "spills": {rid: (sorted((repr(g), m) for g, m in sp["mask"].items()),
                         sp["state"]) for rid, sp in d.spills.items()},
    }
    if d.trie is not None:
        state["trie"] = (_trie(d.trie), d.trie.stats(), d.trie.n_nodes,
                         d.trie.clock)
    return state


@pytest.mark.parametrize("walk,seed", [("alloc", s) for s in range(4)]
                         + [("trie", s) for s in range(4)])
def test_lockstep_with_the_reference(walk, seed):
    if walk == "alloc":
        ops_seq = REF._gen_ops(seed, n_ops=150)
        walkers = (REF.Driver(), PORT.Driver())
    else:
        ops_seq = REF._gen_trie_ops(seed, n_ops=120)
        walkers = (REF.TrieDriver(), PORT.TrieDriver())
    assert ops_seq == (PORT._gen_ops(seed, n_ops=150) if walk == "alloc"
                       else PORT._gen_trie_ops(seed, n_ops=120))
    for i, op in enumerate(ops_seq):
        for d in walkers:
            d.apply(op)
        ref, port = (_state(d) for d in walkers)
        assert port == ref, f"op {i} {op}: the port's state differs"
    for d in walkers:
        d.teardown()


# ---------------------------------------------------------------------------
# the paged serving memory model and the escalation ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(page_bytes=0.0, decode_tokens=4, prefill_tokens=16),
    dict(page_bytes=1e6, decode_tokens=4, prefill_tokens=16),
    dict(page_bytes=3.25e9, decode_tokens=1, prefill_tokens=8, dtype_bytes=4),
    dict(page_bytes=7.5e8, decode_tokens=64, prefill_tokens=0,
         weight_bytes=1, replica_weight_bytes=2.5e8),
    dict(page_bytes=1e6, decode_tokens=4, resident_experts=3,
         prefetch_experts=1),
])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_paged_memory_model_equals_the_reference(kw, width):
    jcfg, tcfg = registry()["mixtral-8x7b"], get_config("mixtral-8x7b")
    if width == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    want = jmm.serving_paged_peak_bytes(jcfg, **kw)
    got = tmm.serving_paged_peak_bytes(tcfg, **kw)
    assert got == want
    for budget in (want - 1.0, want, want + 1.0):
        jhw = dataclasses.replace(GPU_64G, hbm_bytes=budget, alpha=1.0)
        thw = dataclasses.replace(H100_80G, hbm_bytes=budget, alpha=1.0)
        assert (tmm.serving_paged_fits(tcfg, thw, **kw)
                == jmm.serving_paged_fits(jcfg, jhw, **kw))


def test_paged_model_charges_pages_verbatim():
    cfg = get_config("mixtral-8x7b").reduced()
    kw = dict(decode_tokens=4, prefill_tokens=16)
    b0 = tmm.serving_paged_peak_bytes(cfg, page_bytes=0, **kw)
    assert tmm.serving_paged_peak_bytes(cfg, page_bytes=1e6, **kw) == b0 + 1e6


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("preemption", [False, True])
def test_admission_escalation_equals_the_reference(prefix_cache, preemption):
    got = TGuard().admission_escalation(prefix_cache, preemption)
    assert got == JGuard().admission_escalation(prefix_cache, preemption)
    assert TGuard.ESCALATION == JGuard.ESCALATION
    assert got[-1] == "wait_or_shed"
    assert ("evict_prefix" in got) == prefix_cache
    assert ("preempt" in got) == preemption
