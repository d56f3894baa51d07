"""The ticket counters of the SELL kernel and K13, one set a CUDA stream
(``spmv_tpu_torch/ops/__init__.py`` ``tickets``, one function for both).

A SELL launch over a stream counts its chunks' completions on one int32
ticket a 1024-row output block; the chunk that takes the last ticket adds
the block's partial sums and sets the ticket back to 0 (K13 keeps one
ticket a row for the pieces of a split row).  Two launches over one
stream that run at once (two CUDA streams, or a graph replayed beside an
eager call) must not count on the same tickets, so the port keeps a set a
(device index, cuda_stream) key.  The JAX package's bound function has no
such state.  These tests hold the choice of set as a function of the key,
with made-up keys on CPU tensors (the plain version, which every CPU
tensor takes, uses no tickets); the card's check is ``chip_smoke.py``'s
``streams`` check.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spmv_tpu_torch.formats.csr_split import pack_csr_split
from spmv_tpu_torch.formats.sell8d import pack_sell8d
from spmv_tpu_torch.formats.sell8w import pack_sell8w, plan_v2
from spmv_tpu_torch.io import generate
from spmv_tpu_torch.ops import csr_split as tsplit, sell as tsell, tickets


def _stream(kind):
    """A small stream of each layout, its chunks cut for 64 SMs so that
    output blocks have several chunks (and so use tickets); ``split`` a
    K13 stream whose rows are cut into pieces of 8 (so use tickets)."""
    a = generate.clustered(3000, 3000, 12, spread=256, dtype=np.float32,
                           seed=5)
    if kind == "split":
        return tsplit.prepare_split(pack_csr_split(a, piece=8), "cpu")
    if kind == "v1":
        p = pack_sell8w(a)
        return tsell.prepare_v1(p.window_ids, tsell.pack_gpk(p.slice_ids),
                                p.meta, p.vals, p.nslices, p.m, p.n, "cpu",
                                nsm=64)
    if kind == "row":
        return tsell.prepare_sell(plan_v2(pack_sell8w(a), g=2), "cpu",
                                  slot_mode=False, nsm=64)
    return tsell.prepare_sell(pack_sell8d(a)[0], "cpu", slot_mode=True,
                              nsm=64)


KINDS = ["slot", "row", "v1", "split"]
#: the SELL kinds (the interleaving below follows the SELL chunk tables)
SELL_KINDS = KINDS[:3]
#: kind → (its product, its plain version)
PRODUCTS = {k: (tsell.sell_spmv, tsell.sell_plain) for k in SELL_KINDS}
PRODUCTS["split"] = (tsplit.split_spmv, tsplit.split_plain)


@pytest.mark.parametrize("kind", KINDS)
def test_tickets_are_one_set_a_stream_key(kind):
    st = _stream(kind)
    assert st.tickets_by_stream == {}
    a = tickets(st, ("cpu", 1))
    b = tickets(st, ("cpu", 2))
    # two keys give two tensors, the same key the same tensor
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert tickets(st, ("cpu", 1)) is a
    assert tickets(st, ("cpu", 2)) is b
    assert set(st.tickets_by_stream) == {("cpu", 1), ("cpu", 2)}
    # a set's size: one a SELL output block, one a K13 row
    size = max(st.m, 1) if kind == "split" else st.nblocks
    for t in (a, b):
        assert t.dtype == torch.int32 and t.shape == (size,)
        assert t.device == torch.device("cpu") and not bool(t.any())
    # a key's set is the one that stays: what a launch leaves is kept
    a[0] = 3
    assert int(tickets(st, ("cpu", 1))[0]) == 3
    assert not bool(tickets(st, ("cpu", 2)).any())


@pytest.mark.parametrize("kind", KINDS)
def test_entry_is_made_zero_on_first_use(kind):
    st = _stream(kind)
    # the device index and the stream both part of the key
    keys = [(0, 0), (1, 0), (0, 7)]
    sets = [tickets(st, k) for k in keys]
    assert len({t.data_ptr() for t in sets}) == len(keys)
    assert all(not bool(t.any()) for t in sets)


@pytest.mark.parametrize("kind", KINDS)
def test_a_replace_copy_has_its_own_tickets(kind):
    st = _stream(kind)
    tickets(st, ("cpu", 1))[:] = 1
    copy = dataclasses.replace(st)
    assert copy.tickets_by_stream == {}
    assert not bool(tickets(copy, ("cpu", 1)).any())
    assert bool(tickets(st, ("cpu", 1)).all())


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_product_uses_no_tickets(kind):
    st = _stream(kind)
    product, plain = PRODUCTS[kind]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(st.n)
                         .astype(np.float32))
    y0 = product(st, x)
    assert st.tickets_by_stream == {}
    assert bool(torch.equal(y0, plain(st, x)))


def _last_chunks(nchunks_of_block, order, sets):
    """The kernel's ticket protocol over two launches A and B whose chunk
    completions interleave in ``order`` (a list of ("A" | "B", block)):
    each completion takes a ticket from ``sets[launch]``, and the one that
    takes the block's last ticket reduces it and sets it to 0.  Returns
    each launch's blocks in the order they were reduced, and for each the
    chunks of that launch done by then."""
    done = {"A": {}, "B": {}}
    reduced = {"A": [], "B": []}
    for launch, b in order:
        done[launch][b] = done[launch].get(b, 0) + 1
        t = sets[launch]
        t[b] += 1
        if t[b] == nchunks_of_block[b]:
            reduced[launch].append((b, done[launch][b]))
            t[b] = 0
    return reduced


@pytest.mark.parametrize("kind", SELL_KINDS)
def test_two_streams_interleaved(kind):
    # the fault that one set a stream repairs: with A's and B's chunks of
    # one block interleaved, a shared set lets a launch reduce a block
    # before all of its own chunks are written (and the other never
    # reduces it); a set a stream key reduces each block once a launch,
    # after its own chunks
    st = _stream(kind)
    bcp = st.block_chunk_ptr.numpy()
    per = np.diff(bcp)
    b = int(np.argmax(per))
    assert per[b] > 1
    order = ([("A", b)] * (per[b] - 1) + [("B", b)]
             + [("A", b)] + [("B", b)] * (per[b] - 1))
    shared = tickets(st, ("cpu", 0)).numpy().copy()
    got = _last_chunks(per, order, {"A": shared, "B": shared})
    # B reduces after its first chunk and again after its last; A never
    assert got == {"A": [], "B": [(b, 1), (b, per[b])]}
    own = {"A": tickets(st, ("cpu", 1)).numpy().copy(),
           "B": tickets(st, ("cpu", 2)).numpy().copy()}
    got = _last_chunks(per, order, own)
    assert got == {"A": [(b, per[b])], "B": [(b, per[b])]}
    assert not own["A"].any() and not own["B"].any()
