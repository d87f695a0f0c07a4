"""Spatially-sharded multi-chip codec: per-shard bitstreams + GSPMD halos.

Scale-out of the codec path (SURVEY.md §2.3.3-4): the image's
rows are sharded over a 1-D ``sp`` mesh axis; each device entropy-codes
its own tile with its own chained rANS stream, while the interpolator
convs and CDF tables run under GSPMD — XLA inserts the halo exchanges
(collective-permute) for the small layer-0 receptive fields
automatically.  The reference has no distributed codec at all
(single-GPU, graphs/models/LLICTI_nets.py:344-509); this is the
spatial/context-parallel analog built for a device mesh.

Program structure: ONE fused jitted program per SCALE runs (raw-band
init or interleave) -> 3x(conv -> 3x(CDF table -> per-shard rANS decode
-> write-back)) -> (scale 0) inverse color transform.  The encoder
calls the *same executable* with ``enable=0`` — the rANS scans are
skipped under lax.cond and per-shard per-symbol (start, freq) pairs
come out for the encoder's chain — so encoder and decoder compute every
CDF in the same compiled program with identical shardings:
bit-exactness by construction.  Decode = exactly S dispatches per
image (``dispatch_counts``); encode = S + S grouped per-shard rANS
chain programs.  (The single-chip codec goes further — one whole-image
program — which GSPMD sharding does not need: per-scale keeps compile
units small while the mesh hides the dispatch latency.)

Supported model subset = the single-chip Codec's: clrchs=3 with
clr_joint_mode 0/1/2 (incl. clrjnt0seqmd), normal or logistic mixtures.

Simplifications vs the single-chip codec:
* The image is replicate-padded up front so H is a multiple of
  G * 2**(Lmax+1) and W of 2**(Lmax+1) (original size in the header,
  cropped after decode).  Pad-flag bookkeeping then vanishes: every
  band is coded full-size.  The few padded rows are highly predictable
  (replicated pixels) so their rate cost is small.
* One rANS stream per shard (G blobs); lane states flush per shard.

Bitstream layout:
  streams[0] = [hdr, minmax_int16, raw_x00_rgb]
      hdr = [S u8, G u8, last_h u16, last_w u16, orig_H u32, orig_W u32]
  streams[1] = [blob_0, ..., blob_{G-1}]
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codec import (CONV_PRECISION, codec_jit, dense_group_params,
                     gmm_slice_params, sym_channel)
from ..coder import rans_device as rd
from ..config import ModelConfig
from ..models.llicti import LLICTIModel
from ..ops.color import (rgb_int_to_ycocg_r_int, rgb_int_to_ycocg_r_int_np,
                         ycocg_r_int_to_rgb_int)
from ..ops.gmm import cdf_sampling_points, gmm_cdf_table
from ..ops.wavelet import interleave_scale, lazy_dwt

INV255 = np.float32(1.0 / 255.0)
RANGE_BUCKET = 32


def make_sp_mesh(shards: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if shards is not None:
        devices = devices[:shards]
    return Mesh(np.array(devices), axis_names=("sp",))


def _bucket_range(min_val: int, max_val: int) -> Tuple[int, int]:
    lo = (min_val // RANGE_BUCKET) * RANGE_BUCKET
    hi = -((-(max_val + 1)) // RANGE_BUCKET) * RANGE_BUCKET - 1
    return int(lo), int(hi)


def _bucket(n: int) -> int:
    return max(64, -(-n // 4096) * 4096)


class ShardedCodec:
    """Encoder/decoder sharding H over a 1-D device mesh.

    Per-shard independent rANS streams; NN/CDF math under GSPMD with
    automatic halo exchange.  Supports the same model subset as the
    single-chip Codec: clrchs=3, clr_joint_mode 0/1/2 (incl.
    clrjnt0seqmd), normal or logistic mixtures.
    """

    @staticmethod
    def _check_cfg(cfg: ModelConfig) -> None:
        assert cfg.clrchs == 3 and cfg.clr_joint_mode in (0, 1, 2)
        assert cfg.distribution in ("normal", "logistic")
        assert cfg.num_mixtures > 1
        assert cfg.ycocg
        assert not cfg.subtract_mean
        if cfg.clr_joint_mode == 0 and cfg.clrjnt0seqmd:
            assert cfg.activfun != "GDN1", (
                "GDN1 couples channel groups; seqmd coding needs an "
                "elementwise activation for per-color causality")

    @classmethod
    def supports(cls, cfg: ModelConfig) -> bool:
        """True if this codec can entropy-code models with this config."""
        try:
            cls._check_cfg(cfg)
            return True
        except AssertionError:
            return False

    def __init__(self, cfg: ModelConfig, params, mesh: Optional[Mesh] = None,
                 num_lanes: int = 128):
        self._check_cfg(cfg)
        seqmd = cfg.clr_joint_mode == 0 and cfg.clrjnt0seqmd
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_sp_mesh()
        self.G = self.mesh.devices.size
        self.N = num_lanes
        self.last_slice_bits: Optional[List[List[int]]] = None
        self.last_ideal_bits: Optional[List[List[float]]] = None
        self.last_slice_bits_batch: Optional[List] = None
        self.last_ideal_bits_batch: Optional[List] = None
        # dense block-diagonal execution of grouped convs (same math,
        # one contraction — llicti_tpu/codec.py:dense_group_params), at
        # the single-chip codec's explicit conv precision
        params = dense_group_params(params, cfg)
        self.model = LLICTIModel(cfg=cfg, dense_groups=True,
                                 precision=CONV_PRECISION)
        mesh_ = self.mesh
        G, N = self.G, self.N
        c = cfg.cond_channels
        clr_off = 1 if cfg.clr_joint_mode == 1 else 0
        logistic = cfg.distribution == "logistic"
        self._c = c
        self._clr_off = clr_off

        def sym_ch(b, clr):
            return sym_channel(cfg, b, clr)

        repl = NamedSharding(mesh_, P())
        sh_img = NamedSharding(mesh_, P(None, "sp", None, None))
        sh_row = NamedSharding(mesh_, P("sp"))
        self.sh_img = sh_img
        self.repl = repl
        self.sh_row = sh_row
        self._zeros_cache = {}
        self.params = jax.tree.map(lambda x: self._put(x, repl), params)
        model = self.model

        # ---- fused per-SCALE program ----------------------------------------
        # ONE executable per scale runs (raw-band init for the coarsest OR
        # interleave of the previous scale) -> 3x(conv -> 3x(CDF ->
        # per-shard rANS decode -> write-back)), plus the final inverse
        # color transform at scale 0 — same granularity the single-chip
        # codec had before its whole-image fusion (decode = 1 dispatch per
        # scale, was 3 + plumbing).  Both directions call this executable
        # with identical shapes AND shardings, so every CDF is computed by
        # the same compiled program on the same device — bit-exact across
        # encode/decode (the encoder passes enable=0: rANS scans are
        # skipped under lax.cond and per-shard per-symbol (start, freq)
        # pairs come out for its chain).
        def _band_body_sp(params_, y_lev, words, states, offs, enable, sf,
                          scl, b, ranges, pts3):
            if seqmd:
                base = model.apply(params_, y_lev[..., 0:c * (b + 1)],
                                   scl, b, method=LLICTIModel.band_base)
            else:
                pmap = model.apply(params_, y_lev[..., 0:c * (b + 1)],
                                   scl, b, method=LLICTIModel.band_params)
            h, w = y_lev.shape[1], y_lev.shape[2]
            h_loc = h // G
            n_loc = h_loc * w
            bkt = _bucket(n_loc)
            for clr in range(3):
                if seqmd:
                    y_seq = y_lev[..., sym_ch(b, 0):sym_ch(b, 0) + 2]
                    pmap = model.apply(
                        params_, base, y_seq, scl, b, clr,
                        method=LLICTIModel.band_params_seq)
                minv, maxv = ranges[clr]
                stdevs, means, weights = gmm_slice_params(
                    cfg, pmap, y_lev, b, clr)
                # pts3[clr] is a runtime operand (one cached grid per
                # range, as in llicti_tpu/codec.py:_cdf_cum)
                cum = rd.cdf_float_to_cum_int32(gmm_cdf_table(
                    pts3[clr], stdevs, means, weights, logistic=logistic))
                cum = jax.lax.with_sharding_constraint(cum, sh_img)

                def body(cum_blk, y_blk, words_blk, states_blk, off_blk, en,
                         b=b, clr=clr, minv=minv, bkt=bkt, n_loc=n_loc,
                         h_loc=h_loc, w=w):
                    on = en > 0
                    cc = cum_blk[0]  # [h_loc, w, Lp]

                    def enc_sf(cc):
                        yv = y_blk[0, :, :, sym_ch(b, clr)]
                        sym = jnp.round(yv * 255.0).astype(jnp.int32) - minv
                        sym = jnp.clip(sym, 0, cc.shape[-1] - 2)[..., None]
                        iota = jnp.arange(cc.shape[-1], dtype=jnp.int32)
                        lo = jnp.sum(jnp.where(iota == sym, cc, 0), axis=-1)
                        hi = jnp.sum(jnp.where(iota == sym + 1, cc, 0),
                                     axis=-1)
                        return (jnp.pad(lo.reshape(-1), (0, bkt - n_loc)),
                                jnp.pad((hi - lo).reshape(-1),
                                        (0, bkt - n_loc)))

                    def no_sf(cc):
                        z = jnp.zeros((bkt,), jnp.int32)
                        return z, z

                    st_arr, fr_arr = jax.lax.cond(on, no_sf, enc_sf, cc)
                    cum2 = cc.reshape(n_loc, -1)

                    def dec(args):
                        w_, s_, o_ = args
                        return rd.rans_decode_body(cum2, w_, s_, o_, N, n_loc)

                    def skip(args):
                        _w, s_, o_ = args
                        return jnp.zeros((n_loc,), jnp.int32), s_, o_

                    syms, st2, off2 = jax.lax.cond(
                        on, dec, skip,
                        (words_blk[0], states_blk[0], off_blk[0]))
                    vals = (syms.reshape(1, h_loc, w) + minv).astype(
                        jnp.float32) * INV255
                    cur = y_blk[..., sym_ch(b, clr)]
                    y_blk = y_blk.at[..., sym_ch(b, clr)].set(
                        jnp.where(on, vals, cur))
                    return (y_blk, st2[None], off2[None],
                            st_arr[None], fr_arr[None])

                y_lev, states, offs, st_arr, fr_arr = jax.shard_map(
                    body, mesh=mesh_,
                    in_specs=(P(None, "sp", None, None),
                              P(None, "sp", None, None),
                              P("sp"), P("sp"), P("sp"), P()),
                    out_specs=(P(None, "sp", None, None), P("sp"), P("sp"),
                               P("sp"), P("sp")),
                    check_vma=False)(cum, y_lev, words, states, offs, enable)
                sf.append(st_arr)
                sf.append(fr_arr)
            return y_lev, states, offs

        @partial(codec_jit, static_argnums=(9, 10),
                 in_shardings=(repl, repl, sh_img, sh_img, sh_row, sh_row,
                               sh_row, repl, repl))
        def scale_fn(params_, raw_u8, y_prev, y_direct, words, states, offs,
                     enable, pts3, scl, ranges):
            """Decode-or-encode one whole scale in one executable.

            raw_u8: the raw uint8 header band (used at scl == S-1 only).
            y_prev: the previous (coarser) scale tensor (used otherwise;
            pass y_direct as a shape-matched dummy at the coarsest scale).
            y_direct: the encoder's precomputed y_list[scl] (sharded
            zeros when decoding).  A runtime select keeps both directions
            inside the SAME executable, so CDF floats cannot diverge.
            """
            S = cfg.num_scales
            shift = jnp.array([127, 0, 0], jnp.int32)
            if scl == S - 1:
                ycocg = rgb_int_to_ycocg_r_int(raw_u8.astype(jnp.int32))
                x00 = (ycocg - shift).astype(jnp.float32) * INV255
                h, w = x00.shape[1], x00.shape[2]
                y0 = jnp.zeros((1, h, w, 4 * c), jnp.float32)
                y0 = y0.at[..., clr_off:clr_off + 3].set(x00)
            else:
                x00 = interleave_scale(y_prev, c)
                h, w = x00.shape[1], x00.shape[2]
                y0 = jnp.zeros((1, h, w, 4 * c), jnp.float32)
                y0 = y0.at[..., 0:c].set(x00)
            y0 = jax.lax.with_sharding_constraint(y0, sh_img)
            on = enable > 0
            y_lev = jnp.where(on, y0, y_direct)
            sf = []
            for b in range(3):
                y_lev, states, offs = _band_body_sp(
                    params_, y_lev, words, states, offs, enable, sf,
                    scl, b, ranges, pts3)
            if scl == 0:
                y_c = interleave_scale(y_lev, c)
                y_3ch = y_c[..., clr_off:clr_off + 3]
                ycocg = jnp.round(y_3ch * 255.0).astype(jnp.int32) + shift
                rgb = ycocg_r_int_to_rgb_int(ycocg).astype(jnp.uint8)
            else:
                rgb = jnp.zeros((1, 1, 1, 3), jnp.uint8)
            # [9, G, bkt] stacks: one pair per scale for the grouped encode
            st9 = jnp.stack(sf[0::2])
            fr9 = jnp.stack(sf[1::2])
            # per-slice IDEAL code length from the quantized tables the
            # coder uses: sum -log2(freq/2^16) over real symbols, reduced
            # across shards (GSPMD inserts the psum) — same closure leg
            # as the single-chip codec (llicti_tpu/codec.py image_fn).
            # Zeros on decode (sf skipped under cond); harmless.
            fr_f = jnp.maximum(fr9, 1).astype(jnp.float32)
            ideal9 = jnp.sum(
                jnp.where(fr9 > 0, np.float32(16.0) - jnp.log2(fr_f), 0.0),
                axis=(1, 2))
            return y_lev, states, offs, st9, fr9, rgb, ideal9

        # ---- grouped per-shard rANS encode: one program per scale ----------
        # Chains the scale's 9 slices (reverse decode order) through each
        # shard's lane states in ONE dispatch; integer-only, so grouping
        # has no float-determinism hazard.
        @partial(codec_jit, donate_argnums=(4,))
        def encode_group_fn(st9, fr9, states, cursors, bufs):
            def body(st9, fr9, states_blk, cur_blk, buf_blk):
                states = states_blk[0]
                cursor = cur_blk[0]
                buf = buf_blk[0]
                curs = []
                for i in range(8, -1, -1):  # reverse decode order
                    buf, cursor, states = rd.rans_encode_body(
                        st9[i, 0], fr9[i, 0], states, cursor, buf, N)
                    curs.append(cursor)
                return (buf[None], states[None],
                        jnp.stack(curs)[:, None])

            sp3 = P(None, "sp")
            return jax.shard_map(
                body, mesh=mesh_,
                in_specs=(sp3, sp3, P("sp"), P("sp"), P("sp")),
                out_specs=(P("sp"), P("sp"), sp3),
                check_vma=False)(st9, fr9, states, cursors, bufs)

        # ---- front end (encode) ------------------------------------------
        @partial(codec_jit, static_argnums=(1,), in_shardings=(sh_img,))
        def front_fn(rgb_u8, levels):
            rgb_int = rgb_u8.astype(jnp.int32)
            ycocg = rgb_int_to_ycocg_r_int(rgb_int)
            mm = (jnp.min(ycocg[..., 0]), jnp.max(ycocg[..., 0]),
                  jnp.min(ycocg[..., 1]), jnp.max(ycocg[..., 1]),
                  jnp.min(ycocg[..., 2]), jnp.max(ycocg[..., 2]))
            shift = jnp.array([127, 0, 0], jnp.int32)
            x = (ycocg - shift).astype(jnp.float32) * INV255
            if clr_off:
                zrs = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
                x = jnp.concatenate([zrs, x], axis=-1)
            last_stride = 2 ** (max(levels) + 1)
            x00_raw = rgb_int[:, ::last_stride, ::last_stride, :].astype(
                jnp.uint8)
            y_list = lazy_dwt(x, levels, pad=False)
            y_list = [jax.lax.with_sharding_constraint(y, sh_img)
                      for y in y_list]
            return tuple(y_list), mm, x00_raw

        @partial(codec_jit, static_argnums=(1,), out_shardings=sh_row)
        def pad_words_fn(w, cap):
            return jnp.zeros((G, cap), w.dtype).at[:, : w.shape[1]].set(w)

        @partial(codec_jit, in_shardings=(sh_img, sh_img))
        def ycocg_err_fn(y_lev, xorg_u8):
            """Pre-color-transform decode check (reference
            LLICTI_nets.py:168-171, decompres(..., xorg)): max abs error
            between decoded YCoCg ints and the transform of the original,
            isolating coder bugs from inverse-color-transform bugs."""
            y_c = interleave_scale(y_lev, c)
            y_3ch = y_c[..., clr_off:clr_off + 3]
            ycocg_dec = jnp.round(y_3ch * 255.0).astype(jnp.int32) + \
                jnp.array([127, 0, 0], jnp.int32)
            ycocg_org = rgb_int_to_ycocg_r_int(xorg_u8.astype(jnp.int32))
            return jnp.max(jnp.abs(ycocg_dec - ycocg_org))

        self._scale_fn = scale_fn
        self._encode_group = encode_group_fn
        self._front = front_fn
        self._pad_words = pad_words_fn
        self._ycocg_err = ycocg_err_fn
        self._last_y_lev = None
        # dispatch economics: jitted-program calls per decode/encode,
        # reported by tools/eval + tests (VERDICT r2 weak #3)
        self.dispatch_counts = {"decode": 0, "encode": 0}
        # cached committed scalar flags (multi-process-safe; see _put)
        self._zero = self._put(np.zeros((), np.int32), repl)
        self._one = self._put(np.ones((), np.int32), repl)

    # ---- multi-process-safe host<->device helpers ----------------------
    # When the sp mesh spans OS processes (jax.distributed; the multi-host
    # pod analog), plain device_put/device_get only touch addressable
    # shards.  _put builds a global array from the identical host value
    # every process holds; _fetch all-gathers non-replicated arrays to
    # replicated before the get.  Single-process: plain put/get.

    def _put(self, arr, sharding):
        arr = np.asarray(arr)
        if jax.process_count() == 1:
            return jax.device_put(arr, sharding)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    def _fetch(self, arrays):
        if jax.process_count() == 1:
            return jax.device_get(arrays)

        def rep(a):
            if getattr(a, "is_fully_replicated", True):
                return a
            key = ("rep", a.shape, str(a.dtype))
            if key not in self._zeros_cache:
                self._zeros_cache[key] = jax.jit(
                    lambda t: t, out_shardings=self.repl)
            return self._zeros_cache[key](a)

        return jax.device_get(jax.tree.map(rep, arrays))

    def _sharded_zeros(self, shape) -> jnp.ndarray:
        if shape not in self._zeros_cache:
            self._zeros_cache[shape] = self._put(
                np.zeros(shape, np.float32), self.sh_img)
        return self._zeros_cache[shape]

    def _dummy_row(self, kind, shape, dtype, fill) -> jnp.ndarray:
        """Cached read-only row-sharded constant buffers (encoder dummies)."""
        key = (kind, shape, fill)
        if key not in self._zeros_cache:
            self._zeros_cache[key] = self._put(
                np.full(shape, fill, dtype), self.sh_row)
        return self._zeros_cache[key]

    def _pts3(self, ranges) -> Tuple[jnp.ndarray, ...]:
        """Cached replicated sampling grids (runtime operands)."""
        out = []
        for minv, maxv in ranges:
            key = ("pts", minv, maxv)
            if key not in self._zeros_cache:
                self._zeros_cache[key] = self._put(
                    cdf_sampling_points(minv, maxv), self.repl)
            out.append(self._zeros_cache[key])
        return tuple(out)

    # ------------------------------------------------------------------
    def _pad_multiple(self) -> Tuple[int, int]:
        st = 2 ** (max(self.cfg.dwtlevels) + 1)
        return self.G * st, st

    def _clr_range(self, clr: int, minmax) -> Tuple[int, int]:
        """Per-image bucketed dynamic range, incl. Y (clamped to the
        reference's [-127, 128]) — same policy as the single-chip
        Codec._clr_range, so the mesh path pays no rate/CDF-width
        penalty vs single-chip."""
        if clr == 0:
            lo, hi = _bucket_range(int(minmax[0]) - 127,
                                   int(minmax[3]) - 127)
            return max(lo, -127), min(hi, 128)
        return _bucket_range(int(minmax[clr]), int(minmax[3 + clr]))

    def _ranges(self, minmax):
        return tuple(self._clr_range(clr, minmax) for clr in range(3))

    def _scale_dims(self, S: int, last_h: int, last_w: int):
        """(scl, h, w) per scale in decode order (padded => exact doubling)."""
        h, w = last_h, last_w
        dims = [(S - 1, h, w)]
        for scl in range(S - 2, -1, -1):
            h, w = 2 * h, 2 * w
            dims.append((scl, h, w))
        return dims

    def _words_cap(self, S: int, last_h: int, last_w: int) -> int:
        """Worst-case stream words per shard, shape-derived."""
        total = self.N
        for _scl, h, w in self._scale_dims(S, last_h, last_w):
            n_loc = (h // self.G) * w
            total += 9 * (-(-_bucket(n_loc) // self.N) * self.N)
        return -(-total // 16384) * 16384

    # ------------------------------------------------------------------
    def _encode_dispatch(self, y_list, x00_raw, minmax):
        """Enqueue one image's encode; returns device handles only.
        Dispatches: S scale programs + S grouped chain programs."""
        S = self.cfg.num_scales
        ranges = self._ranges(minmax)
        last_h = y_list[S - 1].shape[1]
        last_w = y_list[S - 1].shape[2]
        cap = self._words_cap(S, last_h, last_w)
        dummy_words = self._dummy_row("words", (self.G, cap), np.uint16, 0)
        dummy_states = self._dummy_row(
            "states", (self.G, self.N), np.uint32, rd.RANS_L)
        dummy_offs = self._dummy_row("offs", (self.G,), np.int32, 0)
        zero = self._zero
        # per scale (decode order): stacked (start, freq) pairs from the
        # SAME executables the decoder runs (enable=0); the encoder
        # passes its own y_list tensors as y_prev/y_direct (the runtime
        # select discards the interleave path)
        scale_sf = []
        ideals = []  # decode order (coarsest first), each [9] device
        for scl in range(S - 1, -1, -1):
            y_prev = y_list[scl + 1] if scl < S - 1 else y_list[scl]
            _y, _s, _o, st9, fr9, _rgb, ideal9 = self._scale_fn(
                self.params, x00_raw, y_prev, y_list[scl], dummy_words,
                dummy_states, dummy_offs, zero, self._pts3(ranges), scl,
                ranges)
            self.dispatch_counts["encode"] += 1
            scale_sf.append((st9, fr9))
            ideals.append(ideal9)
        # chained per-shard encode: scales fine->coarse (reverse decode
        # order), one grouped program per scale.  bufs is donated to the
        # chain programs, so it must be a FRESH buffer each call (the
        # cached dummies above are read-only).
        states = self._put(
            np.full((self.G, self.N), rd.RANS_L, np.uint32), self.sh_row)
        bufs = self._put(np.zeros((self.G, cap), np.int32), self.sh_row)
        cursors = self._put(np.zeros((self.G,), np.int32), self.sh_row)
        curs_per_scale = []  # encode order; each [9, G]
        for st9, fr9 in reversed(scale_sf):
            bufs, states, curs9 = self._encode_group(
                st9, fr9, states, cursors, bufs)
            self.dispatch_counts["encode"] += 1
            cursors = curs9[-1]
            curs_per_scale.append(curs9)
        return curs_per_scale, states, bufs, ideals

    def _encode_finalize(self, streams, curs_np_list, states_np, packed_np):
        """Assemble per-shard blobs + per-slice bit accounting."""
        S = self.cfg.num_scales
        G = self.G
        blobs = []
        curs_all = np.concatenate(curs_np_list, axis=0)  # [9S, G] cumulative
        final = curs_all[-1]
        for g in range(G):
            blobs.append(rd.pack_stream_packed(
                np.asarray(packed_np[g, : int(final[g])]),
                np.asarray(states_np[g])))
        streams.append(blobs)
        # per-slice word counts (encode order, per shard) -> decode-order
        # bits summed over shards
        prev = np.zeros((1, G), curs_all.dtype)
        counts = np.diff(np.concatenate([prev, curs_all], axis=0), axis=0)
        bits_enc_order = counts.sum(axis=1) * 16  # [9S]
        bits_dec_order = bits_enc_order[::-1]
        self.last_slice_bits = [
            [int(v) for v in bits_dec_order[9 * i: 9 * i + 9]]
            for i in range(S)
        ]
        return streams

    def compress(self, rgb: np.ndarray) -> List[List[bytes]]:
        return self.compress_many([rgb])[0]

    def compress_many(self, imgs) -> List[List[List[bytes]]]:
        """Pipelined encode of several images: all front transforms
        dispatch first, then all slice/chain programs, with one host sync
        per stage instead of several per image."""
        cfg = self.cfg
        S = cfg.num_scales
        mh, mw = self._pad_multiple()
        stage1 = []
        for rgb in imgs:
            if rgb.ndim == 3:
                rgb = rgb[None]
            assert rgb.shape[0] == 1 and rgb.shape[-1] == 3
            orig_h, orig_w = rgb.shape[1], rgb.shape[2]
            H = -(-orig_h // mh) * mh
            W = -(-orig_w // mw) * mw
            padded = np.pad(rgb, ((0, 0), (0, H - orig_h), (0, W - orig_w),
                                  (0, 0)), mode="edge")
            x_dev = self._put(padded.astype(np.uint8), self.sh_img)
            y_list, mm, x00_raw = self._front(x_dev, cfg.dwtlevels)
            stage1.append((y_list, mm, x00_raw, orig_h, orig_w))
        mms = self._fetch([(s[1], s[2]) for s in stage1])
        stage2 = []
        for (y_list, _, x00_raw, orig_h, orig_w), (mm_np, x00_np) in zip(
                stage1, mms):
            (min_y, max_y, min_co, max_co,
             min_cg, max_cg) = (int(v) for v in mm_np)
            minmax = [min_y, min_co, min_cg, max_y, max_co, max_cg]
            last_h = y_list[S - 1].shape[1]
            last_w = y_list[S - 1].shape[2]
            hdr = (np.array([S, self.G], np.uint8).tobytes()
                   + np.array([last_h, last_w], np.uint16).tobytes()
                   + np.array([orig_h, orig_w], np.uint32).tobytes())
            streams = [[hdr, np.array(minmax, np.int16).tobytes(),
                        np.asarray(x00_np).tobytes()]]
            curs, states, bufs, ideals = self._encode_dispatch(
                y_list, x00_raw, minmax)
            stage2.append((streams, curs, states, bufs, ideals))
        got = self._fetch([(s[1], s[2], s[4]) for s in stage2])
        packed_bufs = []
        for (_st, _c, _s, bufs, _i), (curs_np_list, _states, _id) in zip(
                stage2, got):
            maxc = int(np.concatenate(curs_np_list, axis=0)[-1].max())
            bucket = min(bufs.shape[1], -(-max(1, maxc) // 16384) * 16384)
            packed_bufs.append(bufs[:, :bucket])
        packed_all = self._fetch(packed_bufs)
        out = []
        per_act, per_ideal = [], []
        for (streams, _c, _s, _b, _i), (curs_np_list, states_np,
                                        ideals_np), packed in zip(
                stage2, got, packed_all):
            out.append(self._encode_finalize(
                streams, [np.asarray(x) for x in curs_np_list],
                np.asarray(states_np), np.asarray(packed)))
            per_act.append(self.last_slice_bits)
            # ideals_np: decode order (coarsest first), each [9]
            per_ideal.append([[float(v) for v in row] for row in ideals_np])
        # same accounting contract as the single-chip codec: *_batch =
        # one table per image, flat attrs = elementwise sums
        self.last_slice_bits_batch = per_act
        self.last_ideal_bits_batch = per_ideal
        self.last_slice_bits = [
            [sum(t[s][i] for t in per_act) for i in range(9)]
            for s in range(S)]
        self.last_ideal_bits = [
            [sum(t[s][i] for t in per_ideal) for i in range(9)]
            for s in range(S)]
        return out

    # ------------------------------------------------------------------
    def decompress_dispatch(self, streams: List[List[bytes]]):
        """Enqueue one image's decode; returns (device uint8 array,
        orig_h, orig_w).  Dispatches are async, so several decodes can be
        enqueued back-to-back and fetched together."""
        cfg = self.cfg
        hdr = streams[0][0]
        S = int(np.frombuffer(hdr[:1], np.uint8)[0])
        G = int(np.frombuffer(hdr[1:2], np.uint8)[0])
        assert S == cfg.num_scales and G == self.G
        last_h, last_w = (int(v) for v in np.frombuffer(hdr[2:6], np.uint16))
        orig_h, orig_w = (int(v) for v in np.frombuffer(hdr[6:14], np.uint32))
        minmax = [int(v) for v in np.frombuffer(streams[0][1], np.int16)]
        raw = np.frombuffer(streams[0][2], np.uint8).reshape(
            1, last_h, last_w, 3)
        ranges = self._ranges(minmax)

        states_np = np.zeros((G, self.N), np.uint32)
        word_arrs = []
        for g, blob in enumerate(streams[1]):
            s, wds = rd.unpack_stream(blob, self.N)
            states_np[g] = s
            word_arrs.append(wds.astype(np.uint16))
        wmax = max(1, max(a.size for a in word_arrs))
        up = -(-wmax // 4096) * 4096
        w_small = np.zeros((G, up), np.uint16)
        for g, a in enumerate(word_arrs):
            w_small[g, : a.size] = a
        cap = self._words_cap(S, last_h, last_w)
        words = self._pad_words(self._put(w_small, self.sh_row), cap)
        states = self._put(states_np, self.sh_row)
        offs = self._put(np.zeros((G,), np.int32), self.sh_row)
        one = self._one

        raw_dev = self._put(np.ascontiguousarray(raw), self.repl)
        c4 = 4 * cfg.cond_channels
        y_lev = None
        rgb = None
        for scl, h, w in self._scale_dims(S, last_h, last_w):
            y_direct = self._sharded_zeros((1, h, w, c4))
            y_prev = y_lev if scl < S - 1 else y_direct
            y_lev, states, offs, _st, _fr, rgb, _ideal = self._scale_fn(
                self.params, raw_dev, y_prev, y_direct, words, states,
                offs, one, self._pts3(ranges), scl, ranges)
            self.dispatch_counts["decode"] += 1
        self._last_y_lev = y_lev
        return rgb, orig_h, orig_w

    def decompress(self, streams: List[List[bytes]],
                   xorg: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode; with ``xorg`` also runs the pre-color-transform YCoCg
        check (recorded in ``last_ycocg_err``)."""
        out, orig_h, orig_w = self.decompress_dispatch(streams)
        out = np.asarray(self._fetch(out))
        if xorg is not None:
            if xorg.ndim == 3:
                xorg = xorg[None]
            y_lev = self._last_y_lev
            H, W = y_lev.shape[1] * 2, y_lev.shape[2] * 2
            xpad = np.pad(
                xorg, ((0, 0), (0, H - xorg.shape[1]),
                       (0, W - xorg.shape[2]), (0, 0)), mode="edge")
            self.last_ycocg_err = int(self._fetch(self._ycocg_err(
                y_lev, self._put(xpad.astype(np.uint8), self.sh_img))))
        return out[:, :orig_h, :orig_w, :]

    def decompress_many(self, streams_list) -> List[np.ndarray]:
        """Pipelined decode of several images: enqueue all, sync once."""
        outs = [self.decompress_dispatch(s) for s in streams_list]
        fetched = self._fetch([o[0] for o in outs])
        return [np.asarray(f)[:, :oh, :ow, :]
                for f, (_d, oh, ow) in zip(fetched, outs)]

    def prepare_decode(self, streams):
        """Stage a container's buffers on the mesh once; returns
        fn() -> device rgb handle (resident serving path, mirroring the
        single-chip Codec.prepare_decode): each call re-runs only the S
        per-scale program dispatches on resident buffers — the sustained
        per-dispatch time is the mesh's decode throughput, transfers
        excluded."""
        cfg = self.cfg
        hdr = streams[0][0]
        S = int(np.frombuffer(hdr[:1], np.uint8)[0])
        G = int(np.frombuffer(hdr[1:2], np.uint8)[0])
        assert S == cfg.num_scales and G == self.G
        last_h, last_w = (int(v) for v in np.frombuffer(hdr[2:6], np.uint16))
        minmax = [int(v) for v in np.frombuffer(streams[0][1], np.int16)]
        raw = np.frombuffer(streams[0][2], np.uint8).reshape(
            1, last_h, last_w, 3)
        ranges = self._ranges(minmax)
        states_np = np.zeros((G, self.N), np.uint32)
        word_arrs = []
        for g, blob in enumerate(streams[1]):
            s, wds = rd.unpack_stream(blob, self.N)
            states_np[g] = s
            word_arrs.append(wds.astype(np.uint16))
        wmax = max(1, max(a.size for a in word_arrs))
        up = -(-wmax // 4096) * 4096
        w_small = np.zeros((G, up), np.uint16)
        for g, a in enumerate(word_arrs):
            w_small[g, : a.size] = a
        cap = self._words_cap(S, last_h, last_w)
        words = jax.block_until_ready(self._pad_words(
            self._put(w_small, self.sh_row), cap))
        states0 = self._put(states_np, self.sh_row)
        offs0 = self._put(np.zeros((G,), np.int32), self.sh_row)
        raw_dev = self._put(np.ascontiguousarray(raw), self.repl)
        one = self._one
        c4 = 4 * cfg.cond_channels
        dims = self._scale_dims(S, last_h, last_w)
        y_dirs = {scl: self._sharded_zeros((1, h, w, c4))
                  for scl, h, w in dims}
        pts3 = self._pts3(ranges)

        def dispatch():
            states, offs = states0, offs0
            y_lev = rgb = None
            for scl, _h, _w in dims:
                y_direct = y_dirs[scl]
                y_prev = y_lev if scl < S - 1 else y_direct
                y_lev, states, offs, _st, _fr, rgb, _ideal = self._scale_fn(
                    self.params, raw_dev, y_prev, y_direct, words, states,
                    offs, one, pts3, scl, ranges)
            return rgb

        return dispatch

    def prepare_encode(self, rgb: np.ndarray):
        """Stage an image on the mesh once; returns fn() ->
        (curs_per_scale, states, bufs, ideals) device handles — the
        resident encode serving path, mirroring the single-chip
        Codec.prepare_encode contract (host finalize excluded: the
        payload stays sharded in HBM, as when a downstream device
        consumer or collective takes it).  The header minmax derives on
        the host via the bit-exact numpy lifting twin, so each dispatch
        is sync-free."""
        cfg = self.cfg
        if rgb.ndim == 3:
            rgb = rgb[None]
        assert rgb.shape[0] == 1 and rgb.shape[-1] == 3
        mh, mw = self._pad_multiple()
        H = -(-rgb.shape[1] // mh) * mh
        W = -(-rgb.shape[2] // mw) * mw
        padded = np.pad(
            rgb, ((0, 0), (0, H - rgb.shape[1]), (0, W - rgb.shape[2]),
                  (0, 0)), mode="edge").astype(np.uint8)
        x_dev = jax.block_until_ready(self._put(padded, self.sh_img))
        ycocg = rgb_int_to_ycocg_r_int_np(padded[0])
        minmax = [int(ycocg[..., c].min()) for c in range(3)] + \
                 [int(ycocg[..., c].max()) for c in range(3)]

        def dispatch():
            y_list, _mm, x00_raw = self._front(x_dev, cfg.dwtlevels)
            return self._encode_dispatch(y_list, x00_raw, minmax)

        return dispatch

    @staticmethod
    def num_bytes(streams: List[List[bytes]]) -> int:
        return sum(len(s) for g in streams for s in g)
