"""The device tier over a mesh of cards against the JAX package, bit for bit.

A mesh of cards (``Mesh(["cuda:0", ..., "cuda:3"])``) puts each process's
row block on its own card (a :class:`~repro_torch.core.context.MeshStore`)
and ships the network phase between cards.  There is no card here, so each
test forces that route onto ``P`` CPU blocks, each its own allocation, by
patching the one predicate, ``Mesh.spans_devices``, to ``True`` while it
runs the port on a ``make_mesh(P, device="cpu")``: the fused Alltoallv then
stages each sender's chunks with kernel 4's plain version and ships them
through ``Mesh.all_to_all``'s per-card copies, and every other collective
copies between blocks.

The JAX results are ``tests/test_torch_mesh.py``'s, from its one
subprocess (the ``jax_mesh`` fixture keeps them for the test session), and
the one-card mesh's are the port's own on the same inputs.  Covered: PSRS at
P ∈ {2, 4} × k ∈ {1, 2} × the three drivers × α ∈ {None, 1} ×
direct/indirect × ``use_kernel`` on random and duplicate-heavy keys (the
output, ``rcount``, ``oflow`` and every final store word against JAX, the
modeled ledger against JAX where its side ran the configuration and against
the one-card mesh always); every Alltoallv variant of
``test_alltoallv_at_P4_matches_jax``; the fused route at P = 2 and at odd
word offsets; the five collectives; a JAX ``P = 4`` store carried over after
``partition``; a traced run's events.  Every comparison is exact, the
float32 reductions against the one-card mesh too (against JAX the float32
sums within 1e-6, as in ``tests/test_torch_mesh.py``).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro_torch.core.collectives as collectives
from repro_torch import interop
from repro_torch.core import Mesh, Pems, PemsConfig, make_mesh
from repro_torch.core.context import MeshStore
from repro_torch.pems_apps import psrs_plan, psrs_sort
from test_torch_mesh import (  # noqa: F401  (jax_mesh: the shared fixture)
    _ALPHAS, _COLL_CALLS, _COLL_FIELDS, _FIELDS, _ODD, _ODD_FIELDS,
    _VARIANTS, K, N_V, P4, V, _coll_close, _keys, _layout, _ledger, _words,
    jax_mesh)
from test_torch_obs import _multiset


@pytest.fixture
def cards(monkeypatch):
    """``cards(fn)``: ``fn()`` with every mesh a mesh of cards."""
    def run(fn):
        with monkeypatch.context() as mp:
            mp.setattr(Mesh, "spans_devices", True)
            return fn()
    return run


def _pems(P=P4, k=K, fields=_FIELDS, **kw):
    return Pems(PemsConfig(v=V, k=k, P=P, **kw), _layout(fields),
                mesh=make_mesh(P, device="cpu"), device="cpu")


def _store(pems, words):
    return interop.store_from_numpy(pems.layout, words, device="cpu",
                                    mesh=pems.mesh)


def _blocks_apart(store, P):
    """A mesh store of ``P`` blocks, no two sharing a storage."""
    assert isinstance(store, MeshStore) and store.P == P
    assert len({b.untyped_storage().data_ptr() for b in store.blocks}) == P


def _a2a(words, use_kernel, kw, **pems_kw):
    """``(pems, store)`` after one Alltoallv of ``words``."""
    pems = _pems(**pems_kw)
    return pems, pems.alltoallv(_store(pems, words), use_kernel=use_kernel,
                                **kw)


@pytest.fixture
def calls(monkeypatch):
    """The senders' kernel 4 stagings (``nq = 1``) and the
    ``Mesh.all_to_all`` calls while the test runs."""
    got = {"stage": 0, "ship": 0}
    stage, ship = collectives.assemble_words, Mesh.all_to_all

    def staged(*a, **kw):
        got["stage"] += a[4] == 1
        return stage(*a, **kw)

    def shipped(self, send, recv):
        got["ship"] += 1
        return ship(self, send, recv)

    monkeypatch.setattr(collectives, "assemble_words", staged)
    monkeypatch.setattr(Mesh, "all_to_all", shipped)
    return got


# --------------------------------------------------------------------------- #
# Alltoallv                                                                    #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", list(_VARIANTS))
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("alpha", _ALPHAS)
@pytest.mark.parametrize("k", [1, K])
def test_alltoallv_over_cards_matches_jax(jax_mesh, cards, calls, k, alpha,
                                          use_kernel, variant):
    """Every word equal to JAX's and to the one-card mesh's, the ledger
    JAX's; the fused route stages once a sender a chunk and ships each
    chunk (and its counts) through ``Mesh.all_to_all``."""
    kw = _VARIANTS[variant]
    pems, store = cards(lambda: _a2a(_words(), use_kernel, kw, k=k,
                                     alpha=alpha))
    assert pems.cards
    _blocks_apart(store, P4)
    got = interop.store_to_numpy(store)
    np.testing.assert_array_equal(got, jax_mesh[f"a2a/None/{variant}/words"])
    if variant == "fill":
        np.testing.assert_array_equal(got, jax_mesh[f"a2a/{alpha}/fill/words"])
    if k == K:                                 # the JAX side runs k = 2
        assert pems.ledger.snapshot() == _ledger(jax_mesh,
                                                 f"a2a/{alpha}/fill")
    chunks = len(collectives._chunks(pems.cfg))
    counted = "send_counts" in kw
    if use_kernel:
        assert calls == {"stage": chunks * P4,
                         "ship": chunks * (1 + counted)}
    else:                                      # the dense transposes
        m = V // P4
        assert calls == {"stage": 0,
                         "ship": (1 + counted) * -(-m // (alpha or m))}
    one, want = _a2a(_words(), use_kernel, kw, k=k, alpha=alpha)
    assert not one.cards
    np.testing.assert_array_equal(got, interop.store_to_numpy(want))
    assert one.ledger.snapshot() == pems.ledger.snapshot()


@pytest.mark.parametrize("alpha", _ALPHAS)
def test_fused_alltoallv_over_two_cards_matches_jax(jax_mesh, cards, alpha):
    pems, store = cards(lambda: _a2a(_words(), True, _VARIANTS["fill"], P=2,
                                     alpha=alpha))
    _blocks_apart(store, 2)
    tag = f"a2a_P2/{alpha}/fill"
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  jax_mesh[tag + "/words"])
    assert pems.ledger.snapshot() == _ledger(jax_mesh, tag)


@pytest.mark.parametrize("alpha", _ALPHAS)
def test_fused_alltoallv_over_cards_at_odd_word_offsets(jax_mesh, cards,
                                                        alpha):
    pems, store = cards(lambda: _a2a(_words(_ODD_FIELDS), True, _ODD,
                                     fields=_ODD_FIELDS, alpha=alpha))
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  jax_mesh[f"a2a_odd/{alpha}/words"])
    assert pems.ledger.snapshot() == _ledger(jax_mesh, f"a2a_odd/{alpha}")


# --------------------------------------------------------------------------- #
# The other collectives                                                        #
# --------------------------------------------------------------------------- #

def test_bcast_and_gather_over_cards_match_jax(jax_mesh, cards):
    def run():
        pems = _pems()
        store = pems.bcast(_store(pems, _words()), "a", root=5)
        return pems, pems.gather(store, "root_in", "root_out", root=13)

    pems, store = cards(run)
    _blocks_apart(store, P4)
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  jax_mesh["rooted/words"])
    assert pems.ledger.snapshot() == _ledger(jax_mesh, "rooted")


def test_allgather_reduce_allreduce_over_cards_match_jax(jax_mesh, cards):
    """The one-card mesh's words bit for bit (float32 sums included: the
    blocks are gathered into the operand the one-card mesh reduces), JAX's
    within ``_coll_close``, and JAX's ledger."""
    def run():
        pems = _pems(fields=_COLL_FIELDS)
        store = _store(pems, _words(_COLL_FIELDS))
        for method, args, kw in _COLL_CALLS:
            store = getattr(pems, method)(store, *args, **kw)
        return pems, store

    pems, store = cards(run)
    _blocks_apart(store, P4)
    got = interop.store_to_numpy(store)
    np.testing.assert_array_equal(got, interop.store_to_numpy(run()[1]))
    _coll_close(got, jax_mesh["coll/words"], pems.layout)
    assert pems.ledger.snapshot() == _ledger(jax_mesh, "coll")


# --------------------------------------------------------------------------- #
# PSRS                                                                         #
# --------------------------------------------------------------------------- #

_ONE_CARD = {}


def _one_card_ledger(P, k, driver, alpha, mode):
    """The one-card mesh's ledger of the configuration (it depends on
    neither the keys nor the kernel route)."""
    key = (P, k, driver, alpha, mode)
    if key not in _ONE_CARD:
        _, pems = psrs_sort(torch.from_numpy(_keys("random")), v=V, k=k, P=P,
                            mesh=make_mesh(P, device="cpu"), alpha=alpha,
                            driver=driver, mode=mode, device="cpu",
                            return_pems=True)
        _ONE_CARD[key] = pems.ledger.snapshot()
    return _ONE_CARD[key]


def _jax_store(jax_mesh, keys):
    """JAX's final PSRS store on these keys: every word depends on the keys
    and v alone, not on P, k, α, the driver, mode or kernel route."""
    return jax_mesh["store/4/2/None" if keys == "random" else "carry/merge"]


@pytest.mark.parametrize("keys", ["random", "dups"])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("mode", ["direct", "indirect"])
@pytest.mark.parametrize("alpha", [None, 1])
@pytest.mark.parametrize("driver", ["explicit", "sliced", "async"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("P", [2, 4])
def test_psrs_over_cards_matches_jax(jax_mesh, cards, P, k, driver, alpha,
                                     mode, use_kernel, keys):
    x = _keys(keys)
    kw = dict(k=k, P=P, alpha=alpha, driver=driver, mode=mode,
              use_kernel=use_kernel, device="cpu")

    def run():
        mesh = make_mesh(P, device="cpu")
        out, pems = psrs_sort(torch.from_numpy(x), v=V, mesh=mesh,
                              return_pems=True, **kw)
        plan, load, steps, extract = psrs_plan(V, N_V, mesh=mesh, **kw)
        store = load(torch.from_numpy(x).reshape(V, N_V))
        for _, step in steps:
            store = step(store)
        return out, pems, store, extract(store)

    out, pems, store, (result, rcount, oflow) = cards(run)
    _blocks_apart(store, P)
    np.testing.assert_array_equal(out.numpy(), np.sort(x))
    # rcount, oflow and every other word of the final store: JAX's.
    final = _jax_store(jax_mesh, keys)
    np.testing.assert_array_equal(interop.store_to_numpy(store), final)
    lo = pems.layout
    for name, got in (("rcount", rcount), ("oflow", oflow)):
        off = lo.offset(name)
        np.testing.assert_array_equal(got.numpy()[:, 0],
                                      final[:, off].view(np.int32))
    tag = f"psrs/{P}/{k}/{driver}/{alpha}/{mode}"
    if tag + "/ledger" in jax_mesh:
        assert pems.ledger.snapshot() == _ledger(jax_mesh, tag)
    assert pems.ledger.snapshot() == _one_card_ledger(P, k, driver, alpha,
                                                      mode)


@pytest.mark.parametrize("P, k, alpha", [(4, 2, None), (2, 1, 1)])
def test_psrs_final_store_over_cards_matches_jax_at_its_P(jax_mesh, cards, P,
                                                          k, alpha):
    """The final store against the JAX run of the same ``P``, ``k`` and
    ``α``."""
    def run():
        _, load, steps, _ = psrs_plan(V, N_V, k=k, P=P, alpha=alpha,
                                      mesh=make_mesh(P, device="cpu"),
                                      device="cpu")
        store = load(torch.from_numpy(_keys("random")).reshape(V, N_V))
        for _, step in steps:
            store = step(store)
        return store

    np.testing.assert_array_equal(interop.store_to_numpy(cards(run)),
                                  jax_mesh[f"store/{P}/{k}/{alpha}"])


def test_jax_P4_store_carries_over_cards_after_partition(jax_mesh, cards):
    """A JAX ``P = 4`` store (the global ``[v, words]``) taken after
    ``partition`` is split into the cards' blocks and finishes with the JAX
    run's final words."""
    def run():
        pems, _, steps, _ = psrs_plan(V, N_V, k=2, P=4, alpha=1,
                                      mesh=make_mesh(4, device="cpu"),
                                      device="cpu")
        store = interop.store_from_numpy(
            pems.layout, jax_mesh["carry/partition"], mesh=pems.mesh)
        _blocks_apart(store, 4)
        names = [name for name, _ in steps]
        for _, step in steps[names.index("partition") + 1:]:
            store = step(store)
        return store

    np.testing.assert_array_equal(interop.store_to_numpy(cards(run)),
                                  jax_mesh["carry/merge"])


@pytest.mark.parametrize("driver, alpha", [("explicit", 1), ("async", None)])
def test_traced_psrs_over_cards_gives_the_one_card_events(cards, tmp_path,
                                                          driver, alpha):
    """A traced run over cards records the same multiset of events as the
    one-card mesh's, and sorts the same."""
    x = torch.from_numpy(_keys("random"))

    def traced(name):
        tp = str(tmp_path / f"{name}.json")
        out = psrs_sort(x, v=V, k=K, P=P4, mesh=make_mesh(P4, device="cpu"),
                        alpha=alpha, driver=driver, trace=True,
                        trace_path=tp, device="cpu")
        with open(tp) as f:
            return out, json.load(f)

    out, trace = cards(lambda: traced("cards"))
    want, one = traced("one")
    assert torch.equal(out, want)
    assert _multiset(trace) == _multiset(one)


# --------------------------------------------------------------------------- #
# The store and the executor                                                   #
# --------------------------------------------------------------------------- #

def test_executor_places_each_block_on_its_card(cards):
    """``init`` gives one block a process, on ``mesh.devices[p]``, each its
    own allocation; ``init_fn`` sees each block's global IDs; a gathered
    field is a copy in process order."""
    pems = _pems()
    assert pems.devices == [torch.device("cpu")] and not pems.cards
    store = cards(lambda: _pems().init(
        lambda rhos: {"scnt": rhos[:, None].expand(-1, V)}))
    _blocks_apart(store, P4)
    assert store.v == V and store.m == V // P4
    np.testing.assert_array_equal(
        store.field("scnt")[:, 0].numpy(), np.arange(V))
    for p in range(P4):
        assert torch.equal(store.field("scnt", p)[:, 0],
                           torch.arange(p * 4, (p + 1) * 4, dtype=torch.int32))
    gathered = store.field("scnt")
    gathered += 1                                 # a copy, not a view
    assert int(store.field("scnt", 0)[0, 0]) == 0
    words = store.field_words_view("scnt")        # gathered words
    store.with_field_words("scnt", words + 7)     # split back, in place
    assert torch.equal(store.field_words_view("scnt", 2), words[8:12] + 7)
    store.with_field("scnt", [torch.zeros(4, V)] * P4)
    assert not bool(store.field("scnt").any())
    with pytest.raises(TypeError, match="one shape"):
        MeshStore(store.layout, [store.blocks[0], store.blocks[1][:2]])
    with pytest.raises(ValueError, match="2 block values for 4 blocks"):
        store.with_field("scnt", [store.field("scnt", 0)] * 2)


def test_forced_route_is_the_cards_route(cards):
    """The forced predicate is what the executor reads: a mesh of cards'
    executor drains and synchronises every card (none here, on the CPU)."""
    pems = cards(lambda: _pems())
    assert pems.cards and pems.devices == [torch.device("cpu")] * P4
    pems.synchronize()
    store = cards(lambda: _store(pems, _words()))
    assert isinstance(store, MeshStore)
    stored = _store(_pems(), _words())
    assert not isinstance(stored, MeshStore)
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  interop.store_to_numpy(stored))
