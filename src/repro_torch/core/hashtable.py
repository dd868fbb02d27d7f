"""Algorithm 4 — InsertIntoTable / AddInTable, the plain PyTorch version.

The paper's table uses linear probing with ``atomicCAS`` because many GPU
threads insert into one row's table at once.  Here, as in the reference,
each row's stream is consumed *in order*, so a key's sum is taken in stream
order and the table is deterministic.  All rows of a chunk advance in
lockstep over the stream position (the reference ``vmap``s a ``scan``),
so the Python loop runs once per stream position, never once per row.

Hash function: ``uint32(key) * 2654435761 mod capacity`` (Knuth
multiplicative), linear probe stride 1, probe bound ``capacity``.  PyTorch
has little uint32 arithmetic, so the hash is taken in int64 and masked to
32 bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MULTIPLIER = 2654435761
EMPTY = -1
INT_MAX = 2**31 - 1
# Slots examined per vectorised probe step: a window of the probe sequence
# is read at once and the first hit-or-empty slot in it is taken, which is
# the slot a one-at-a-time probe would stop at.
PROBE_WINDOW = 32


class HashTable(NamedTuple):
    """One row's table: keys (cap,) int32 (``EMPTY`` where unused), vals
    (cap,) and count, a 0-d int32 (Algorithms 2/3's uniqueCount)."""
    keys: torch.Tensor
    vals: torch.Tensor
    count: torch.Tensor


def make_table(capacity: int, dtype=torch.float32,
               device="cuda") -> HashTable:
    """An empty table of ``capacity`` slots on ``device``."""
    return HashTable(
        torch.full((capacity,), EMPTY, dtype=torch.int32, device=device),
        torch.zeros((capacity,), dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def insert(table: HashTable, key, val, accumulate: bool = True
           ) -> HashTable:
    """One Algorithm-4 insert (linear probing) into ``table``, returning
    the new table (``table`` is left as it was).  ``key`` < 0 is a padding
    no-op.  ``accumulate`` adds ``val`` to the key's slot; without it only
    the key is placed.  A key that finds no hit or empty slot within
    ``capacity`` probes is dropped, as in the reference.  The probe
    sequence is read at once and the first hit-or-empty slot taken, so
    nothing is read back to the host."""
    cap = table.keys.shape[0]
    dev = table.keys.device
    key = torch.as_tensor(key, dtype=torch.int32, device=dev)
    val = torch.as_tensor(val, dtype=table.vals.dtype, device=dev)
    probe = (hash_slot(key.clamp(min=0), cap)
             + torch.arange(cap, device=dev)) % cap
    slots = table.keys[probe]
    stop = (slots == key) | (slots == EMPTY)
    first = stop.to(torch.int8).argmax()
    found = (key >= 0) & stop[first]
    at = probe[first]
    claim = found & (slots[first] == EMPTY)
    keys = table.keys.clone()
    keys[at] = torch.where(claim, key, keys[at])
    vals = table.vals
    if accumulate:
        vals = vals.clone()
        vals[at] = torch.where(found, vals[at] + val, vals[at])
    return HashTable(keys, vals, table.count + claim.to(torch.int32))


def hash_slot(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """Home slot of each key (int64).  Keys must be >= 0 (< 2**31)."""
    h = (keys.to(torch.int64) * MULTIPLIER) & 0xFFFFFFFF
    return h % capacity


def insert_stream(keys: torch.Tensor, vals: torch.Tensor, capacity: int):
    """Insert each row's padded stream of (key, val) into its own table.

    keys: (R, L) int32, ``-1`` padded; vals: (R, L).
    Returns (table keys (R, capacity) int32 ``EMPTY``-padded in probe order,
    table vals (R, capacity), uniqueCount (R,) int32).  A key that finds no
    hit or empty slot within ``capacity`` probes is dropped, as in the
    reference (the Table-I sizing guarantees a free slot).
    """
    r, length = keys.shape
    dev = keys.device
    tk = torch.full((r, capacity), EMPTY, dtype=torch.int32, device=dev)
    tv = torch.zeros((r, capacity), dtype=vals.dtype, device=dev)
    count = torch.zeros(r, dtype=torch.int32, device=dev)
    flat_k, flat_v = tk.view(-1), tv.view(-1)
    row_base = torch.arange(r, device=dev) * capacity
    window = torch.arange(PROBE_WINDOW, device=dev)
    # one column per stream position; positions where every row is padding
    # are skipped (read back once, up front)
    keys_t = keys.t().contiguous()
    vals_t = vals.t().contiguous()
    home_t = hash_slot(keys_t.clamp(min=0), capacity)
    busy = (keys_t >= 0).any(1).tolist()
    for t in range(length):
        if not busy[t]:
            continue
        k, v, pos = keys_t[t], vals_t[t], home_t[t]
        active = k >= 0
        probes = 0
        while True:
            slots_at = (pos[:, None] + window) % capacity
            slots = torch.gather(tk, 1, slots_at)
            stop = (slots == k[:, None]) | (slots == EMPTY)
            if capacity - probes < PROBE_WINDOW:
                stop &= window < capacity - probes
            first = stop.to(torch.int8).argmax(1, keepdim=True)
            found = active & stop.gather(1, first)[:, 0]
            at = row_base + slots_at.gather(1, first)[:, 0]
            old_k, old_v = flat_k[at], flat_v[at]
            claim = found & (old_k == EMPTY)
            flat_k[at] = torch.where(claim, k, old_k)
            flat_v[at] = torch.where(found, old_v + v, old_v)
            count += claim
            active &= ~found
            probes += PROBE_WINDOW
            if probes >= capacity or not bool(active.any()):
                break
            pos = pos + PROBE_WINDOW
    return tk, tv, count


def extract_sorted(tk: torch.Tensor, tv: torch.Tensor, count: torch.Tensor,
                   out_cap: int):
    """Element gathering + column-index sorting (Algorithm 5 steps 2–3).

    Stable-sorts each row's occupied slots by column and trims to
    ``out_cap`` (``out_cap`` >= uniqueCount must hold).  Returns (cols
    (R, out_cap) int32 ``-1``-padded, vals (R, out_cap) 0-padded, count).
    """
    skey = torch.where(tk == EMPTY, INT_MAX, tk)
    _, order = torch.sort(skey, dim=1, stable=True)
    order = order[:, :out_cap]
    sc = torch.gather(tk, 1, order)
    sv = torch.gather(tv, 1, order)
    valid = torch.arange(order.shape[1], device=tk.device)[None, :] \
        < count[:, None]
    return (torch.where(valid, sc, EMPTY), torch.where(valid, sv, 0),
            count)
