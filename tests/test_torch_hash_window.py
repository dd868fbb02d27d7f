"""The window algorithm of K2's CUDA kernel, emulated in NumPy, against the
reference's Pallas kernel in interpret mode, bit for bit.

``csrc/hash_accum.cu`` inserts a row's stream one window of 32 slots at a
time: every lane looks its key up in parallel, read-only; the keys not
found are placed by the lowest lane of each group of equal keys, in lane
order, a lane whose first empty slot equals a lower lane's waiting for the
next round with the lanes above it; then the lowest lane of each group
adds the group's values to its slot in lane order.  Windows that hold no
product are skipped (the kernel finds them first, a bit a window).
``window_insert`` follows those steps and rounds each sum to float32 as
``__fadd_rn`` does; these tests hold its tables (slots, sums and counts)
against ``repro.kernels.hash_accum.hash_accumulate`` with
``interpret=True``, so the design is exact before the card runs it.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.hash_accum import hash_accumulate as ref_hash_accumulate

EMPTY = -1
MULTIPLIER = 2654435761
WINDOW = 32


def home(key, cap):
    return (key * MULTIPLIER % 2**32) % cap


def insert_window(tk, tv, cap, keys, vals, valid, stats):
    """One window: lane j holds keys[j], vals[j] (a product where
    valid[j]).  Returns the number of keys placed."""
    lanes = range(len(keys))
    slot, pos, dist = [-1] * WINDOW, [0] * WINDOW, [0] * WINDOW
    # 1. look up, read-only: stop at the key or at the first empty slot
    for j in lanes:
        if not valid[j]:
            continue
        pos[j] = home(int(keys[j]), cap)
        while dist[j] < cap:
            s = tk[pos[j]]
            if s == keys[j]:
                slot[j] = pos[j]
                break
            if s == EMPTY:
                break
            pos[j] = (pos[j] + 1) % cap
            dist[j] += 1
    leader = {j: min(i for i in lanes if valid[i] and keys[i] == keys[j])
              for j in lanes if valid[j]}
    # 2. place the keys not found, in lane order, a round at a time
    pending = [j for j in lanes if valid[j] and leader[j] == j
               and slot[j] < 0]
    placed = 0
    while pending:
        full = False
        for j in pending:  # resume at the first empty slot
            while dist[j] >= cap or tk[pos[j]] != EMPTY:
                dist[j] += 1
                if dist[j] >= cap:
                    full = True
                    break
                pos[j] = (pos[j] + 1) % cap
        if full:  # no empty slot is left: every pending key is dropped
            stats["dropped"] += len(pending)
            break
        clash = [j for n, j in enumerate(pending)
                 if any(pos[i] == pos[j] for i in pending[:n])]
        accept = pending if not clash else pending[:pending.index(clash[0])]
        for j in accept:
            tk[pos[j]] = keys[j]
            slot[j] = pos[j]
        placed += len(accept)
        pending = pending[len(accept):]
        stats["rounds"] += 1
        stats["clashes"] += bool(clash)
    # 3. add the values, per slot in lane order, from the table's value
    for j in lanes:
        if valid[j] and leader[j] == j and slot[j] >= 0:
            total = tv[slot[j]]
            for i in lanes:
                if valid[i] and keys[i] == keys[j]:
                    total = np.float32(total + vals[i])
            tv[slot[j]] = total
    return placed


def window_insert(keys, vals, cap, stats=None):
    """The kernel's tables for (R, L) streams."""
    stats = {"rounds": 0, "clashes": 0, "dropped": 0, "skipped": 0} \
        if stats is None else stats
    r, length = keys.shape
    cols = np.full((r, cap), EMPTY, np.int32)
    out = np.zeros((r, cap), np.float32)
    cnt = np.zeros(r, np.int32)
    for row in range(r):
        k, v = keys[row], vals[row]
        for w0 in range(0, len(k), WINDOW):
            kw, vw = k[w0:w0 + WINDOW], v[w0:w0 + WINDOW]
            valid = kw >= 0
            if not valid.any():
                stats["skipped"] += 1
                continue
            cnt[row] += insert_window(cols[row], out[row], cap, kw, vw,
                                      valid, stats)
    return cols, out, cnt


def held_bitwise(keys, vals, cap):
    """The emulation's tables equal the reference kernel's bit for bit;
    returns the emulation's statistics."""
    stats = {"rounds": 0, "clashes": 0, "dropped": 0, "skipped": 0}
    got = window_insert(keys, vals, cap, stats)
    want = ref_hash_accumulate(jnp.asarray(keys), jnp.asarray(vals), cap,
                               interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    return stats


def same_home_keys(cap, n, start=0):
    """``n`` keys >= ``start`` that share one home slot in a ``cap`` table."""
    want = home(start, cap)
    keys, key = [], start
    while len(keys) < n:
        if home(key, cap) == want:
            keys.append(key)
        key += 1
    return keys


@pytest.mark.parametrize("cap,seed", [(64, 0), (64, 1), (1024, 2)])
def test_repeated_keys_in_and_across_windows(cap, seed):
    """Few distinct columns: a key repeats inside one window and across
    windows, so groups of equal keys sum in lane order onto sums that
    earlier windows left."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 12, (3, 150)).astype(np.int32)
    keys[rng.random(keys.shape) < 0.2] = EMPTY
    vals = rng.standard_normal(keys.shape).astype(np.float32)
    stats = held_bitwise(keys, vals, cap)
    assert stats["rounds"] > 0


@pytest.mark.parametrize("start", [40, 64])
def test_windows_of_padding_are_skipped(start):
    """Whole windows of padding (100 slots from ``start`` of a 200-slot
    stream, and a row of nothing but padding) leave the tables as the
    reference's."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 300, (3, 200)).astype(np.int32)
    keys[:, start:start + 100] = EMPTY
    keys[1] = EMPTY
    vals = rng.standard_normal(keys.shape).astype(np.float32)
    stats = held_bitwise(keys, vals, 64)
    assert stats["skipped"] >= 9


def test_full_table_drops_keys():
    """100 distinct keys into 64 slots: the table fills inside a window and
    the keys that find no empty slot are dropped and not counted."""
    rng = np.random.default_rng(7)
    keys = rng.permutation(100).astype(np.int32)[None]
    keys = np.concatenate([keys, keys[:, ::-1]], 1)  # then only hits
    vals = rng.standard_normal(keys.shape).astype(np.float32)
    stats = held_bitwise(keys, vals, 64)
    assert window_insert(keys, vals, 64)[2][0] == 64
    assert stats["dropped"] >= 36  # each absent key, once a pass at least


def test_negative_zero_sums_to_positive_zero():
    """A key whose values are all -0.0 starts from the table's +0.0, as the
    reference does: its sum is +0.0, not -0.0."""
    keys = np.array([[3, 3, 9, -1, 3, 11, 9, 11] * 6], np.int32)
    vals = np.full(keys.shape, -0.0, np.float32)
    vals[0, 5::8] = 1.5  # key 11 mixes -0.0 with other values
    stats = held_bitwise(keys, vals, 64)
    cols, out, _ = window_insert(keys, vals, 64)
    zeros = out[0][np.isin(cols[0], (3, 9))]
    assert len(zeros) == 2 and not np.signbit(zeros).any()
    assert stats["rounds"] == 1


@pytest.mark.parametrize("cap", [64, 1024])
def test_keys_with_one_home_clash_in_a_window(cap):
    """Keys that share a home slot, several in one window, force placement
    rounds: each waits for the lower lane that took its first empty slot,
    and takes the slot a one-at-a-time insert gives it."""
    rng = np.random.default_rng(cap)
    clash = same_home_keys(cap, 20) + same_home_keys(cap, 12, start=5000)
    keys = np.array(clash + list(rng.integers(0, 4 * cap, 60)), np.int32)
    keys = np.stack([keys, rng.permutation(keys)])
    vals = rng.standard_normal(keys.shape).astype(np.float32)
    stats = held_bitwise(keys, vals, cap)
    assert stats["clashes"] > 0
