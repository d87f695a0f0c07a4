"""On-device interleaved rANS entropy coder (pure int32/uint32 JAX).

Why this exists: the reference (and our host backend) ships per-pixel CDF
tables to the CPU coder — ~0.5-1 KB/pixel of PCIe traffic on decode
(reference LLICTI_nets.py:485-493).  We instead keep the CDF
tables in device memory and run the range coder *on the device* as vectorized
integer ops: N independent rANS lanes decode one symbol each per scan
step, so only the actual bitstream (~entropy-sized) ever crosses the
host link.  Integer arithmetic also makes encoder/decoder bit-exactness
trivial (no float determinism constraints on the coder itself).

Coder spec (classic interleaved rANS, 16-bit probabilities):
  * state x: uint32 in [2^16, 2^32); renormalization emits/consumes
    uint16 words.
  * encode(start, freq):  if x >= freq << 16: emit x & 0xFFFF; x >>= 16
                          x = (x // freq) << 16 | (x % freq + start)
  * decode: slot = x & 0xFFFF; s = cdf bin of slot;
            x = freq * (x >> 16) + slot - start;
            if x < 2^16: x = x << 16 | next_word
  * N lanes round-robin one shared word stream: decoder reads forward
    (step-major, lane 0..N-1); encoder runs in exact reverse order.
  * symbol i of a slice maps to (step, lane) = (i // N, i % N); the tail
    is padded with masked no-ops (zero rate).
  * multiple slices chain through the same lane states / stream, so the
    per-image overhead is one N*4-byte state flush (plus nothing per
    slice) — decode order must equal encode's slice order reversed.

CDF tables are int32 cumulative arrays of Lp entries per pixel with
cum[0] == 0 and cum[Lp-1] == 2^16 exactly (see
``cdf_float_to_cum_int32``); every bin has freq >= 1.
"""
from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PROB_BITS = 16
RANS_L = 1 << 16  # lower bound of the state interval


def cdf_float_to_cum_int32(cdf: jnp.ndarray) -> jnp.ndarray:
    """Quantize float CDFs in [0,1] to int32 cum tables for the device coder.

    Same fixed-point contract as the host/torchac uint16 path
    (round(cdf*(2^16-(Lp-1))) + arange, reference LLICTI_nets.py:955-983)
    but kept in int32 with the final entry saturated to exactly 2^16 —
    no wrap-around games needed on device.
    """
    P = cdf.shape[-1]
    new_max = 2 ** 16 - (P - 1)
    q = jnp.round(jnp.clip(cdf, 0.0, 1.0) * new_max).astype(jnp.int32)
    q = jax.lax.cummax(q, axis=q.ndim - 1)
    q = q + jnp.arange(P, dtype=jnp.int32)
    return q.at[..., -1].set(1 << 16)


# ---------------------------------------------------------------------------
# numpy reference implementation (golden model for the jitted version)
# ---------------------------------------------------------------------------


class RansRefEncoder:
    """Scalar numpy reference: N-lane interleaved rANS encoder.

    Call encode_slice for each slice in *reverse* decode order; finish()
    returns (words, final_states).  Words are uint16, to be read forward
    by the decoder.
    """

    def __init__(self, num_lanes: int):
        self.N = num_lanes
        self.states = np.full(num_lanes, RANS_L, np.uint64)
        self.words: List[int] = []  # built reversed; finish() flips

    def encode_slice(self, starts: np.ndarray, freqs: np.ndarray) -> None:
        n = len(starts)
        N = self.N
        T = -(-n // N)
        for t in range(T - 1, -1, -1):
            for l in range(N - 1, -1, -1):
                i = t * N + l
                if i >= n:
                    continue
                start, freq = int(starts[i]), int(freqs[i])
                x = int(self.states[l])
                if x >= (freq << 16):
                    self.words.append(x & 0xFFFF)
                    x >>= 16
                x = ((x // freq) << 16) + (x % freq) + start
                self.states[l] = x

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        words = np.array(self.words[::-1], np.uint16)
        return words, self.states.astype(np.uint32)


class RansRefDecoder:
    def __init__(self, words: np.ndarray, states: np.ndarray):
        self.words = words.astype(np.uint32)
        self.pos = 0
        self.states = states.astype(np.uint64)
        self.N = len(states)

    def decode_slice(self, cum: np.ndarray) -> np.ndarray:
        """cum: [n, Lp] int cumulative tables; returns n symbols."""
        n, Lp = cum.shape
        N = self.N
        T = -(-n // N)
        out = np.zeros(n, np.int32)
        for t in range(T):
            for l in range(N):
                i = t * N + l
                if i >= n:
                    continue
                x = int(self.states[l])
                slot = x & 0xFFFF
                row = cum[i]
                s = int(np.searchsorted(row, slot, side="right")) - 1
                start, freq = int(row[s]), int(row[s + 1] - row[s])
                x = freq * (x >> 16) + slot - start
                if x < RANS_L:
                    x = (x << 16) | int(self.words[self.pos])
                    self.pos += 1
                self.states[l] = x
                out[i] = s
        return out


# ---------------------------------------------------------------------------
# jitted device implementation
# ---------------------------------------------------------------------------


def _u32(x):
    return x.astype(jnp.uint32)


def rans_encode_body_batch(starts, freqs, states, cursor, buf, num_lanes):
    """Traceable reverse-order encode of one slice for K images at once.

    starts/freqs: [K, n] int32 per-symbol (cdf[s], cdf[s+1]-cdf[s]).
    states: [K, N] uint32 carried lane states; cursor: [K] int32 write
    positions into ``buf`` ([K, cap] int32), threaded through the whole
    batch's slice chain.  Each image's stream is independent (its own
    lanes/cursor/buffer row); batching exists to share one scan and give
    the surrounding convs a real batch dimension.  Emitted words land in
    *reverse stream order*; one flip of buf[k, :cursor_k] at assembly
    yields image k's forward stream.
    Returns (buf, cursor, states).
    """
    N = num_lanes
    K, n = starts.shape
    T = -(-n // N)
    pad = T * N - n
    # freq == 0 marks a masked no-op symbol (tail padding); callers may
    # pre-pad to a bucketed length with zero freqs
    starts = jnp.pad(starts, ((0, 0), (0, pad))).reshape(
        K, T, N).astype(jnp.uint32)
    freqs = jnp.pad(freqs, ((0, 0), (0, pad))).reshape(
        K, T, N).astype(jnp.uint32)
    cap = buf.shape[1]

    # The scan carries only the lane states; emitted words/flags come out
    # as stacked ys and are scattered into the shared buffer ONCE (a
    # buffer carried through the scan would be copied every step).
    def step(states, inp):
        start, freq = inp  # [K, N]
        val = freq > 0
        freq_safe = jnp.maximum(freq, 1)
        emit = jnp.logical_and(val, states >= (freq_safe << 16))
        word = (states & 0xFFFF).astype(jnp.int32)
        states = jnp.where(emit, states >> 16, states)
        new_states = ((states // freq_safe) << 16) + (states % freq_safe) + start
        states = jnp.where(val, new_states, states)
        return states, (word, emit)

    # reverse step order: t = T-1 .. 0; scan axis leading
    inputs = (starts[:, ::-1].transpose(1, 0, 2),
              freqs[:, ::-1].transpose(1, 0, 2))
    states, (words_t, emits) = jax.lax.scan(step, states, inputs)
    # emission order per image: ascending reversed-step index, lanes
    # N-1..0 within a step — flatten in that order and place by exclusive
    # prefix sum along the row
    flat_words = words_t[:, :, ::-1].transpose(1, 0, 2).reshape(K, -1)
    flat_emit = emits[:, :, ::-1].transpose(1, 0, 2).reshape(K, -1)
    e32 = flat_emit.astype(jnp.int32)
    pos = cursor[:, None] + jnp.cumsum(e32, axis=1) - e32
    row = jnp.arange(K, dtype=jnp.int32)[:, None]
    idx = jnp.where(flat_emit, row * cap + pos, K * cap)
    buf = buf.reshape(-1).at[idx.reshape(-1)].set(
        flat_words.reshape(-1), mode="drop").reshape(K, cap)
    cursor = cursor + jnp.sum(e32, axis=1)
    return buf, cursor, states


def rans_encode_body(starts, freqs, states, cursor, buf, num_lanes):
    """Single-image wrapper of :func:`rans_encode_body_batch` (K=1)."""
    buf, cursor, states = rans_encode_body_batch(
        starts[None], freqs[None], states[None],
        jnp.reshape(cursor, (1,)).astype(jnp.int32), buf[None], num_lanes)
    return buf[0], cursor[0], states[0]


@partial(jax.jit, static_argnums=(5,), donate_argnums=(4,))
def rans_encode_slice(starts, freqs, states, cursor, buf, num_lanes):
    """Jitted standalone wrapper around :func:`rans_encode_body`."""
    return rans_encode_body(starts, freqs, states, cursor, buf, num_lanes)


@partial(jax.jit, static_argnums=(5,), donate_argnums=(4,))
def rans_encode_group(starts_seq, freqs_seq, states, cursor, buf, num_lanes):
    """Encode a group of slices (already in encode order) in ONE program.

    starts_seq/freqs_seq: tuples of per-slice arrays.  Integer-only, so
    fusing slices has no float-determinism hazard; it exists purely to cut
    per-slice dispatch overhead (one program per scale instead of nine).
    Returns (buf, cursor, states, per-slice cursors tuple).
    """
    cursors = []
    for st, fr in zip(starts_seq, freqs_seq):
        buf, cursor, states = rans_encode_body(st, fr, states, cursor, buf,
                                               num_lanes)
        cursors.append(cursor)
    return buf, cursor, states, tuple(cursors)


def rans_decode_body_batch(cum, words, states, offsets, num_lanes, n):
    """Traceable decode core for K images (call inside a jitted program).

    cum: [K, n, Lp] int32 cumulative tables; words: [K, W] uint16-valued
    streams; states: [K, N] uint32; offsets: [K] int32 read positions.
    Returns (symbols [K, n] int32, states, new offsets).

    Gather-free formulation (written for a backend with slow gathers;
    whether a per-lane binary search is faster on the GPU is an open
    measurement): each scan step loads its *contiguous* [K, N, Lp] row
    block with ``dynamic_slice`` (scalar step index, shared by all
    images) and finds (s, cum[s], cum[s+1]) with masked max/min/sum
    reductions over Lp — elementwise work.  The conditional word refill
    reads one contiguous [N] window per image (K unrolled scalar-offset
    slices) and selects by rank with a one-hot compare instead of a
    gather.
    """
    N = num_lanes
    K, _, Lp = cum.shape
    T = -(-n // N)
    pad = T * N - n
    valid = (jnp.arange(T * N) < n).reshape(T, N)
    if pad:
        cum = jnp.concatenate(
            [cum, jnp.broadcast_to(cum[:, :1], (K, pad, Lp))], axis=1)
    # N-word tail so the refill window never runs out of bounds
    words = jnp.concatenate(
        [words, jnp.zeros((K, N), words.dtype)], axis=1)
    lane_iota = jnp.arange(N, dtype=jnp.int32)

    def step(carry, inp):
        states, offsets = carry  # [K, N], [K]
        t, val = inp  # scalar, [N]
        block = jax.lax.dynamic_slice(cum, (0, t * N, 0), (K, N, Lp))
        slot = (states & 0xFFFF).astype(jnp.int32)
        # largest s with cum[s] <= slot: cum rows are strictly increasing
        # with cum[0] == 0 and cum[Lp-1] == 2^16 > slot, so the masked
        # reductions below are always well-defined
        le = block <= slot[..., None]
        start32 = jnp.max(jnp.where(le, block, 0), axis=-1)
        nxt32 = jnp.min(jnp.where(le, 1 << 16, block), axis=-1)
        s = jnp.sum(le.astype(jnp.int32), axis=-1) - 1
        start = _u32(start32)
        freq = _u32(nxt32 - start32)
        x = freq * (states >> 16) + _u32(slot) - start
        need = jnp.logical_and(val[None, :], x < RANS_L)
        # lane l reads the (#needing lanes with index < l)-th next word
        n32 = need.astype(jnp.int32)
        rank = jnp.cumsum(n32, axis=1) - n32
        win = jnp.concatenate(
            [jax.lax.dynamic_slice(words, (k, offsets[k]), (1, N))
             for k in range(K)], axis=0)  # [K, N]
        w = _u32(jnp.sum(
            jnp.where(rank[..., None] == lane_iota[None, None, :],
                      win[:, None, :], 0), axis=-1))
        x = jnp.where(need, (x << 16) | w, x)
        states = jnp.where(val[None, :], x, states)
        offsets = offsets + jnp.sum(n32, axis=1)
        return (states, offsets), s

    ts = jnp.arange(T)
    (states, offsets), syms = jax.lax.scan(step, (states, offsets),
                                           (ts, valid))
    syms = syms.transpose(1, 0, 2).reshape(K, T * N)[:, :n]
    return syms, states, offsets


def rans_decode_body(cum, words, states, offset, num_lanes, n):
    """Single-image wrapper of :func:`rans_decode_body_batch` (K=1)."""
    syms, states, offsets = rans_decode_body_batch(
        cum[None], words[None], states[None],
        jnp.reshape(offset, (1,)).astype(jnp.int32), num_lanes, n)
    return syms[0], states[0], offsets[0]


@partial(jax.jit, static_argnums=(4, 5))
def rans_decode_slice(cum, words, states, offset, num_lanes, n):
    """Jitted standalone wrapper around :func:`rans_decode_body`."""
    return rans_decode_body(cum, words, states, offset, num_lanes, n)


# ---------------------------------------------------------------------------
# stream assembly helpers
# ---------------------------------------------------------------------------


def pack_stream_packed(packed_rev: np.ndarray,
                       final_states: np.ndarray) -> bytes:
    """Assemble the byte stream from one packed buffer prefix.

    packed_rev: words in encode order (whole-image reverse stream order);
    a single flip yields decode order.  Layout matches pack_stream.
    """
    return (np.asarray(final_states, np.uint32).tobytes()
            + np.ascontiguousarray(
                np.asarray(packed_rev, np.uint16)[::-1]).tobytes())


def pack_stream(word_chunks_rev: Sequence[np.ndarray],
                final_states: np.ndarray) -> bytes:
    """Assemble the byte stream.

    word_chunks_rev: per-slice reversed word arrays in *encode* order
    (reverse decode order) — each chunk's words are reversed internally,
    and later-encoded chunks belong earlier in the decoder's stream.
    Layout: [N states as uint32 LE] [words uint16 LE, decode order].
    """
    parts = [np.asarray(final_states, np.uint32).tobytes()]
    fwd = []
    for chunk in reversed(list(word_chunks_rev)):
        fwd.append(np.asarray(chunk[::-1], np.uint16))
    if fwd:
        parts.append(np.concatenate(fwd).tobytes())
    return b"".join(parts)


def unpack_stream(data: bytes, num_lanes: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (states uint32 [N], words int32 [W])."""
    states = np.frombuffer(data[: 4 * num_lanes], np.uint32).copy()
    words = np.frombuffer(data[4 * num_lanes:], np.uint16).astype(np.int32)
    return states, words
