"""JAX colour-space 4-layer full SW + on-device traceback.

Port of sw_cs_batch.sw_full_cs_batch (itself element-equal to the
reference kernel): lax.scan over read rows, all planes as [B, 4, G] int32
tensors, doubling max-plus scan for the intra-row west chain, fused
on-device traceback. Falls back to the numpy implementation when
unavailable (see mapper._pass2_cs).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C

# small-magnitude NEG so the rank key (value*16 - rank) stays in int32
NEG = jnp.int32(-(2 ** 25))
_NN, _NNW, _WNW, _WW, _NWN, _NWNW, _NWW = 1, 2, 3, 4, 5, 6, 7

_NEXT_PLANE_NP = np.array([0, 1, 0, 0, 2, 1, 0, 2], np.int32)
# plane ids: 0=nw, 1=n, 2=w (indexed by dir-pair code)


@functools.partial(jax.jit, static_argnames=(
    "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "local_alignment", "indel_taboo_len"))
def sw_full_cs_tpu(genome_ls, glen, qr, rlen, ax, ay, alen, awid,
                   revcmpl, xover_rows, gx_col, thresh,
                   *, match: int, mismatch: int, a_gap_open: int,
                   a_gap_ext: int, b_gap_open: int, b_gap_ext: int,
                   local_alignment: bool = False,
                   indel_taboo_len: int = 0):
    """qr: [B, 4, R] precomputed letter layers; xover_rows [B, R];
    gx_col [B] global crossover (row -1 init). Returns packed outputs:
    (packed [B, 12] int32 = [score, bi, bj, bk, nops, read_start,
    genome_start, matches, mismatches, insertions, deletions, crossovers],
    steps_rev [B, R+G] int16-packed op|layer<<2|xover<<4, reverse order).
    """
    B, G = genome_ls.shape
    R = qr.shape[2]
    go_a, ge_a = jnp.int32(-(a_gap_open)), jnp.int32(-(a_gap_ext))
    go_b, ge_b = jnp.int32(-(b_gap_open)), jnp.int32(-(b_gap_ext))
    db = genome_ls.astype(jnp.int32)
    qr = qr.astype(jnp.int32)
    layer_off = jnp.array([0, 1, 1, 1], jnp.int32)[None, :, None]
    jvec = jnp.arange(G, dtype=jnp.int32)[None, :]
    rv = revcmpl
    glen32 = glen.astype(jnp.int32)
    rlen32 = rlen.astype(jnp.int32)
    ax32, ay32 = ax.astype(jnp.int32), ay.astype(jnp.int32)
    alen32, awid32 = alen.astype(jnp.int32), awid.astype(jnp.int32)

    gxb = gx_col.astype(jnp.int32)[:, None, None]
    nw_init = jnp.broadcast_to(layer_off * gxb, (B, 4, G + 1)).astype(
        jnp.int32)
    n_init = nw_init + jnp.int32(b_gap_open)
    w_init = nw_init + jnp.int32(a_gap_open)

    dir12 = np.array([_NWNW, _NWN, _NWW] * 4, np.int32)
    rank12_f = np.arange(12, dtype=np.int32)
    rank12_r = rank12_f.reshape(4, 3)[:, ::-1].reshape(12)
    dir8 = np.array([_NNW, _NN] * 4, np.int32)
    rank8_f = np.arange(8, dtype=np.int32)
    rank8_r = rank8_f.reshape(4, 2)[:, ::-1].reshape(8)

    def band(i):
        x_min = jnp.where(i < ay32, 0,
                          jnp.where(i <= ay32 + alen32 - 1,
                                    ax32 + (i - ay32), ax32 + alen32))
        x_min = jnp.clip(x_min, 0, glen32 - 1)
        x_max = jnp.where(
            i < ay32 - (awid32 - 1), ax32 + awid32 - 2,
            jnp.where(i <= ay32 - (awid32 - 1) + alen32 - 1,
                      ax32 + (awid32 - 1) + (i - (ay32 - (awid32 - 1))),
                      glen32 - 1))
        x_max = jnp.clip(x_max, 0, glen32 - 1)
        return x_min, x_max

    def row(carry, xs):
        nw_p, n_p, w_p, best, bi_, bj_, bk_, bfrm = carry
        i, xcol = xs
        xG = xcol[:, None]                       # [B,1]
        no_taboo = i < rlen32 - indel_taboo_len  # [B]
        x_min, x_max = band(i)
        inb = (jvec >= x_min[:, None]) & (jvec <= x_max[:, None])
        inb4 = inb[:, None, :]

        qri = jax.lax.dynamic_index_in_dim(qr, i, 2, keepdims=False)
        dbn = (db == C.BASE_N)[:, None, :]
        qrn = (qri == C.BASE_N)[:, :, None]
        eq = db[:, None, :] == qri[:, :, None]
        ms = jnp.where(dbn | qrn, 0, jnp.where(eq, match, mismatch)
                       ).astype(jnp.int32)

        nw_d, n_d, w_d = nw_p[:, :, :-1], n_p[:, :, :-1], w_p[:, :, :-1]
        nw_u, n_u = nw_p[:, :, 1:], n_p[:, :, 1:]
        planes3 = jnp.stack([nw_d, n_d, w_d], axis=1)     # [B,3,4,G]
        xpen3 = xG[:, :, None]

        nw_vals, nw_bks, n_vals, n_bks = [], [], [], []
        for k in range(4):
            lorder = [k] + [ll for ll in range(4) if ll != k]
            cand = jnp.concatenate(
                [planes3[:, :, l, :] for l in lorder], axis=1)  # [B,12,G]
            cand = cand.at[:, 3:, :].add(xpen3)
            rank = jnp.where(rv[:, None], jnp.asarray(rank12_r)[None, :],
                             jnp.asarray(rank12_f)[None, :])
            if indel_taboo_len:
                is_n = jnp.asarray(dir12 == _NWN)[None, :, None]
                cand = jnp.where(is_n & ~no_taboo[:, None, None],
                                 NEG * 2, cand)
            key = cand * 16 - rank[:, :, None]
            amax = jnp.argmax(key, axis=1)                   # [B,G]
            val = jnp.take_along_axis(cand, amax[:, None, :], axis=1
                                      )[:, 0, :] + ms[:, k, :]
            bkc = (jnp.asarray(dir12)[amax] << 2) | lorder_arr(lorder, 3)[
                amax]
            resetval = (0 if k == 0 else 1) * xG
            if local_alignment:
                clamp = val <= resetval
                val = jnp.where(clamp, resetval, val)
                bkc = jnp.where(clamp, 0, bkc)
            nw_vals.append(val)
            nw_bks.append(bkc)

            copen = nw_u[:, jnp.asarray(lorder), :] - go_b - ge_b
            cext = n_u[:, jnp.asarray(lorder), :] - ge_b
            cand = jnp.stack([copen, cext], axis=2).reshape(B, 8, G)
            cand = cand.at[:, 2:, :].add(xpen3)
            rank = jnp.where(rv[:, None], jnp.asarray(rank8_r)[None, :],
                             jnp.asarray(rank8_f)[None, :])
            if indel_taboo_len:
                is_open = jnp.asarray(dir8 == _NNW)[None, :, None]
                cand = jnp.where(is_open & ~no_taboo[:, None, None],
                                 NEG * 2, cand)
            key = cand * 16 - rank[:, :, None]
            amax = jnp.argmax(key, axis=1)
            val = jnp.take_along_axis(cand, amax[:, None, :], axis=1)[:, 0,
                                                                      :]
            bkc = (jnp.asarray(dir8)[amax] << 2) | lorder_arr(lorder, 2)[
                amax]
            resetval = (0 if k == 0 else 1) * xG
            if local_alignment:
                clamp = val <= resetval
                val = jnp.where(clamp, resetval, val)
                bkc = jnp.where(clamp, 0, bkc)
            n_vals.append(val)
            n_bks.append(bkc)

        nw_val = jnp.stack(nw_vals, axis=1)
        nw_bk = jnp.stack(nw_bks, axis=1).astype(jnp.int32)
        n_val = jnp.stack(n_vals, axis=1)
        n_bk = jnp.stack(n_bks, axis=1).astype(jnp.int32)

        if local_alignment:
            init_nw_b = layer_off * xG[:, :, None]
            init_n_b = init_nw_b + jnp.int32(b_gap_open)
            init_w_b = init_nw_b + jnp.int32(a_gap_open)
        else:
            init_nw_b = jnp.full((B, 4, 1), NEG, jnp.int32)
            init_n_b = init_nw_b
            init_w_b = init_nw_b
        nw_val = jnp.where(inb4, nw_val, init_nw_b)
        nw_bk = jnp.where(inb4, nw_bk, 0)
        n_val = jnp.where(inb4, n_val, init_n_b)
        n_bk = jnp.where(inb4, n_bk, 0)

        # west chain (doubling max-plus)
        nw_shift = jnp.concatenate([init_nw_b, nw_val[:, :, :-1]], axis=2)
        c_open_w = nw_shift - go_a - ge_a
        if indel_taboo_len:
            c_open_w = jnp.where(no_taboo[:, None, None], c_open_w,
                                 NEG * 2)
        a_elem = c_open_w
        if local_alignment:
            a_elem = jnp.maximum(a_elem, layer_off * xG[:, :, None])
        BIGB = jnp.int32(2 ** 26)
        a_elem = jnp.where(inb4, a_elem, init_w_b)
        b_elem = jnp.where(inb4, jnp.int32(ge_a), BIGB)
        b_elem = jnp.broadcast_to(b_elem, (B, 4, G))
        aa = jnp.concatenate([jnp.broadcast_to(init_w_b, (B, 4, 1)),
                              a_elem], axis=2)
        bb = jnp.concatenate([jnp.full((B, 4, 1), BIGB, jnp.int32),
                              b_elem], axis=2)

        def mp(x, y):
            (a1, b1), (a2, b2) = x, y
            return (jnp.maximum(a2, jnp.maximum(a1 - b2, NEG)),
                    jnp.minimum(b1 + b2, BIGB))
        sa, _sb = jax.lax.associative_scan(mp, (aa, bb), axis=2)
        w_val = sa[:, :, 1:]
        w_prev = sa[:, :, :-1]
        c_ext_w = w_prev - ge_a
        take_ext = jnp.where(rv[:, None, None], ~(c_open_w > c_ext_w),
                             c_ext_w > c_open_w)
        kk4 = jnp.arange(4, dtype=jnp.int32)[None, :, None]
        w_bk = jnp.where(take_ext, (_WW << 2), (_WNW << 2)) | kk4
        if local_alignment:
            resetv = layer_off * xG[:, :, None]
            clamp = w_val <= resetv
            w_val = jnp.where(clamp, resetv, w_val)
            w_bk = jnp.where(clamp, 0, w_bk)
        w_bk = jnp.where(inb4, w_bk, 0)
        w_val = jnp.where(inb4, w_val, init_w_b)

        # score tracking
        if local_alignment:
            rowvalid = (i < rlen32)[:, None] & inb
        else:
            rowvalid = (i == rlen32 - 1)[:, None] & inb
        p1 = jnp.where(rv[:, None, None], w_val, nw_val)
        p3 = jnp.where(rv[:, None, None], nw_val, w_val)
        cand = jnp.stack([p1, n_val, p3], axis=3)
        cand = jnp.transpose(cand, (0, 2, 1, 3)).reshape(B, G * 12)
        cand = jnp.where(jnp.repeat(rowvalid, 12, axis=1), cand, NEG)
        rowmax = jnp.max(cand, axis=1)
        rowarg = jnp.argmax(cand, axis=1)
        upd = rowmax > best
        jj = (rowarg // 12).astype(jnp.int32)
        kk = ((rowarg % 12) // 3).astype(jnp.int32)
        bidx = jnp.arange(B)
        nw_c = nw_val[bidx, kk, jj]
        w_c = w_val[bidx, kk, jj]
        n_c = n_val[bidx, kk, jj]
        frm = nw_bk[bidx, kk, jj]
        fs = nw_c
        frm = jnp.where(w_c > fs, w_bk[bidx, kk, jj], frm)
        fs = jnp.maximum(fs, w_c)
        frm = jnp.where(n_c > fs, n_bk[bidx, kk, jj], frm)
        bi_ = jnp.where(upd, i, bi_)
        bj_ = jnp.where(upd, jj, bj_)
        bk_ = jnp.where(upd, kk, bk_)
        bfrm = jnp.where(upd, frm, bfrm)
        best = jnp.maximum(best, rowmax)

        nw_p2 = jnp.concatenate([init_nw_b, nw_val], axis=2)
        n_p2 = jnp.concatenate([init_n_b, n_val], axis=2)
        w_p2 = jnp.concatenate([init_w_b, w_val], axis=2)
        return ((nw_p2, n_p2, w_p2, best, bi_, bj_, bk_, bfrm),
                (nw_bk.astype(jnp.uint8), n_bk.astype(jnp.uint8),
                 w_bk.astype(jnp.uint8)))

    zero = jnp.zeros(B, jnp.int32)
    carry0 = (nw_init, n_init, w_init, zero, zero, zero, zero, zero)
    xs = (jnp.arange(R, dtype=jnp.int32), jnp.transpose(
        xover_rows.astype(jnp.int32), (1, 0)))
    carry, (bp_nw, bp_n, bp_w) = jax.lax.scan(row, carry0, xs)
    _, _, _, best, bi_, bj_, bk_, bfrm = carry
    # bp_*: [R, B, 4, G] -> [B, R, 4, G]
    bp_nw = jnp.transpose(bp_nw, (1, 0, 2, 3))
    bp_n = jnp.transpose(bp_n, (1, 0, 2, 3))
    bp_w = jnp.transpose(bp_w, (1, 0, 2, 3))
    return _cs_traceback(db, qr, best, bi_, bj_, bk_, bfrm,
                         bp_nw, bp_n, bp_w, thresh)


def _cs_traceback(db, qr, best, bi_, bj_, bk_, bfrm, bp_nw, bp_n, bp_w,
                  thresh):
    """Shared on-device traceback over the 3x4-layer backpointer
    planes; gather-bound (R+G steps), negligible next to the DP."""
    B, _, R = qr.shape
    G = db.shape[1]
    zero = jnp.zeros(B, jnp.int32)
    score = jnp.where(best >= thresh.astype(jnp.int32), best, 0)

    # ---- on-device traceback
    maxsteps = R + G
    bp3 = jnp.stack([bp_nw, bp_n, bp_w], axis=0)   # uint8, keep small
    # flatten for gathers: [3, B, R*4*G]
    bp3f = bp3.reshape(3, B, R * 4 * G)
    nextp = jnp.asarray(_NEXT_PLANE_NP)
    bidx = jnp.arange(B)

    def tstep(carry, _):
        i, j, k, frm, rs, gs, m_, mm_, ins, dele, xo, nops, act = carry
        code = frm >> 2
        lyr = frm & 3
        is_n = act & ((code == _NN) | (code == _NNW))
        is_w = act & ((code == _WNW) | (code == _WW))
        is_nw = act & (code >= _NWN)
        dele = dele + is_n
        ins = ins + is_w
        jj = jnp.clip(j, 0, G - 1)
        ii = jnp.clip(i, 0, R - 1)
        gch = db[bidx, jj]
        rch = qr[bidx, jnp.clip(k, 0, 3), ii]
        okm = (gch == rch) | (gch == C.BASE_N) | (rch == C.BASE_N)
        m_ = m_ + (is_nw & okm)
        mm_ = mm_ + (is_nw & ~okm)
        rs = jnp.where(is_n | is_nw, i, rs)
        gs = jnp.where(is_w | is_nw, j, gs)
        op = jnp.where(is_n, 2, jnp.where(is_w, 1,
                                          jnp.where(is_nw, 3, 0)))
        xov = act & (lyr != k)
        xo = xo + xov
        out = jnp.where(act, op | (k << 2)
                        | (jnp.where(xov, 1, 0) << 4), 0)
        k2 = jnp.where(act, lyr, k)
        nops = nops + act
        i2 = i - (is_n | is_nw)
        j2 = j - (is_w | is_nw)
        nxt = nextp[jnp.clip(code, 0, 7)]
        inb_ = act & (i2 >= 0) & (j2 >= 0)
        flat = (jnp.clip(i2, 0, R - 1) * 4 + jnp.clip(k2, 0, 3)) * G \
            + jnp.clip(j2, 0, G - 1)
        v0 = jnp.take_along_axis(bp3f[0], flat[:, None], 1)[:, 0]
        v1 = jnp.take_along_axis(bp3f[1], flat[:, None], 1)[:, 0]
        v2 = jnp.take_along_axis(bp3f[2], flat[:, None], 1)[:, 0]
        frm2 = jnp.where(nxt == 0, v0, jnp.where(nxt == 1, v1, v2)
                         ).astype(jnp.int32)
        frm2 = jnp.where(inb_, frm2, 0)
        act2 = inb_ & (frm2 != 0)
        return ((i2, j2, k2, frm2, rs, gs, m_, mm_, ins, dele, xo, nops,
                 act2), out.astype(jnp.int16))

    act0 = (bfrm != 0) & (score > 0)
    c0 = (bi_, bj_, bk_, bfrm, zero, zero, zero, zero, zero, zero, zero,
          zero, act0)
    cend, steps_rev = jax.lax.scan(tstep, c0, None, length=maxsteps)
    (_, _, kf, _, rs, gs, m_, mm_, ins, dele, xo, nops, _) = cend
    steps_rev = jnp.transpose(steps_rev, (1, 0))

    # leading crossover when alignment starts in layer != 0
    lead = (score > 0) & (kf != 0) & (nops > 0)
    last = jnp.clip(nops - 1, 0, maxsteps - 1)
    cur = jnp.take_along_axis(steps_rev, last[:, None], 1)[:, 0]
    steps_rev = jnp.where(
        (jnp.arange(maxsteps)[None, :] == last[:, None]) & lead[:, None],
        (cur | (1 << 4))[:, None], steps_rev)
    xo = xo + lead

    packed = jnp.stack([score, bi_, bj_, bk_, nops, rs, gs, m_, mm_, ins,
                        dele, xo], axis=1).astype(jnp.int32)
    # every packed field fits int16 (score < rlen*match < 2^15,
    # positions/counts < R+G); step codes op|layer<<2|xover<<4 < 32 fit
    # int8 — quarters the device->host fetch
    return packed.astype(jnp.int16), steps_rev.astype(jnp.int8)


def lorder_arr(lorder, per):
    return jnp.asarray(np.repeat(lorder, per).astype(np.int32))


def sw_full_cs_dispatch(genome_ls, glen, colours, rlen, initbp,
                        ax, ay, alen, awid, revcmpl, xover_rows, thresh,
                        *, match, mismatch, a_gap_open, a_gap_ext,
                        b_gap_open, b_gap_ext, local_alignment=False,
                        indel_taboo_len=0, device=None):
    """Asynchronously launch the CS full-SW chunk; returns opaque state
    for sw_full_cs_finish.  Splitting dispatch from the fetch lets the
    caller queue every chunk before blocking once instead of paying a
    launch+fetch round trip per chunk."""
    from .sw_cs_batch import cs_layers_batch
    R = colours.shape[1]
    qr = cs_layers_batch(np.asarray(colours, np.uint8),
                         np.asarray(initbp, np.int64))
    kern = functools.partial(
        sw_full_cs_tpu, match=match, mismatch=mismatch,
        a_gap_open=a_gap_open, a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
        b_gap_ext=b_gap_ext, local_alignment=bool(local_alignment),
        indel_taboo_len=int(indel_taboo_len))
    args = (jnp.asarray(genome_ls, jnp.uint8),
            jnp.asarray(glen, jnp.int32),
            jnp.asarray(qr, jnp.uint8),
            jnp.asarray(rlen, jnp.int32),
            jnp.asarray(ax, jnp.int32), jnp.asarray(ay, jnp.int32),
            jnp.asarray(alen, jnp.int32), jnp.asarray(awid, jnp.int32),
            jnp.asarray(np.asarray(revcmpl, bool)),
            jnp.asarray(np.asarray(xover_rows)[:, :R], jnp.int32),
            jnp.asarray(np.asarray(xover_rows)[:, -1], jnp.int32),
            jnp.asarray(thresh, jnp.int32))
    if device is not None:
        with jax.default_device(device):
            packed, steps_rev = kern(*args)
    else:
        packed, steps_rev = kern(*args)
    return (packed, steps_rev, qr)


def sw_full_cs_finish(state, fetched=None):
    """Fetch + unpack one dispatched chunk into a CSBatchResult.
    `fetched` may carry pre-fetched (packed, steps_rev) host arrays
    (from a batched jax.device_get across chunks)."""
    from .sw_cs_batch import CSBatchResult
    packed_d, steps_d, qr = state
    if fetched is not None:
        packed, steps_rev = fetched
    else:
        packed, steps_rev = np.asarray(packed_d), np.asarray(steps_d)
    B = packed.shape[0]
    (score, _bi, _bj, _bk, nops, rs, gs, m_, mm_, ins, dele, xo
     ) = [packed[:, c].astype(np.int64) for c in range(12)]
    maxsteps = steps_rev.shape[1]
    bidx = np.arange(B)[:, None]
    idxm = np.arange(maxsteps)[None, :]
    src = np.clip(nops[:, None] - 1 - idxm, 0, maxsteps - 1)
    steps = np.where(idxm < nops[:, None], steps_rev[bidx, src], 0
                     ).astype(np.int16)
    return CSBatchResult(
        score=score, steps=steps, n_steps=nops, read_start=rs,
        genome_start=gs, rmapped=nops - ins, gmapped=nops - dele,
        matches=m_, mismatches=mm_, insertions=ins, deletions=dele,
        crossovers=xo, qr=qr)


def sw_full_cs_batch_jax(*args, **kw):
    """Synchronous wrapper (dispatch + finish) kept for tests."""
    return sw_full_cs_finish(sw_full_cs_dispatch(*args, **kw))


@functools.partial(jax.jit, static_argnames=(
    "G", "xover", "match", "mismatch", "a_gap_open", "a_gap_ext",
    "b_gap_open", "b_gap_ext", "local_alignment", "indel_taboo_len",
    "vec_kernel", "phase"))
def sw_vec_cs_full_from_index(cs_codes, cs_codes_rc, ls_codes, ls_codes_rc,
                              args, rtab, qr_tab, xover_tab,
                              cs_cat=None, ls_cat=None,
                              *, G: int, xover: int, match: int,
                              mismatch: int, a_gap_open: int,
                              a_gap_ext: int, b_gap_open: int,
                              b_gap_ext: int,
                              local_alignment: bool = False,
                              indel_taboo_len: int = 0,
                              vec_kernel: str,
                              phase: str = "fused"):
    """Fused colour-space filter2 + speculative filter3 against the
    DEVICE-RESIDENT genome planes: one launch per chunk runs the CS
    vector SW on every candidate window AND the 4-layer full SW with
    on-device traceback (the fast-path analogue of the letter-space
    sw_vec_full_*_from_index, see fastpath._fused_dispatch).

    args: [B, 12] int32 rows
      0 gstart (absolute, strand-normalized), 1 glen, 2 owner (read
      row), 3 eff_rc, 4 rlen, 5 rx, 6 ry, 7 rl, 8 rw (widened anchor
      rect), 9 rev tie-break, 10 thresh (full-SW zero-out), 11 initbp.
    rtab: [n_reads, R] colour rows (input strand); qr_tab:
    [n_reads, 4, R] letter-layer translations (cs_layers_batch);
    xover_tab: [n_reads, R] per-position crossover penalties
    (quality-derived, gmapper.c:532-543; uniform `xover` rows for
    quality-less reads). `xover` also serves as the row -1 global
    crossover (sw-full-cs.c:269-271).

    Returns (vec_scores [B], packed [B, 12] int16, steps_rev int8).

    `phase` (static) picks the launch shape: "fused" computes both
    halves (one round trip, ~4-5x the vec cells — right when candidate
    density is low); "vec" returns only
    (vec_scores,); "full" returns only (packed, steps_rev). The split
    phases power the two-phase dispatch at hg-scale candidate density
    (tens of windows/read, few pass1 survivors) where speculation
    wastes most of the full-DP cells — see FastCS._fused_dispatch_cs.
    Per-row results are independent of chunk composition, so fused and
    two-phase produce bit-identical selected alignments.
    """
    from .. import constants as C
    from .sw_jax import fast_window_gather
    from .sw_pallas import sw_vector
    B = args.shape[0]
    R = rtab.shape[1]
    gstart, glen = args[:, 0], args[:, 1]
    owner = jnp.clip(args[:, 2], 0, rtab.shape[0] - 1)
    eff_rc = args[:, 3]
    rlen = args[:, 4]
    rx, ry, rl, rw = args[:, 5], args[:, 6], args[:, 7], args[:, 8]
    rev = args[:, 9] != 0
    thresh = args[:, 10]
    initbp = args[:, 11]

    gwin_cs = fast_window_gather(cs_codes, cs_codes_rc, gstart, eff_rc,
                                 G, cat_words=cs_cat)
    lswin = fast_window_gather(ls_codes, ls_codes_rc, gstart, eff_rc, G,
                               cat_words=ls_cat)
    if gwin_cs is None or lswin is None:
        jidx = jnp.arange(G, dtype=jnp.int32)[None, :]
        pos = jnp.clip(gstart[:, None] + jidx, 0, cs_codes.shape[0] - 1)
        rcb = (eff_rc != 0)[:, None]
        gwin_cs = jnp.where(rcb, cs_codes_rc[pos], cs_codes[pos])
        lswin = jnp.where(rcb, ls_codes_rc[pos], ls_codes[pos])
    cmat = jnp.asarray(C.COLOUR_MAT.reshape(-1))
    g_row0 = cmat[lswin.astype(jnp.int32) * 16 + initbp[:, None]]
    if phase != "full":
        rwin = rtab[owner]
        # In colour space the vector filter's mismatch is
        # match + crossover (gmapper.c:2933-2936 f1_setup), NOT the
        # full-SW mismatch: a colour mismatch at the filter stage is
        # 'one crossover', so dot-colour (N) reads still clear pass1.
        vec_kw = dict(match=match, mismatch=match + xover,
                      a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                      b_gap_open=b_gap_open, b_gap_ext=b_gap_ext)
        vec = sw_vector(gwin_cs, glen, rwin, rlen, g_row0,
                        vec_kernel=vec_kernel, cs_mode=True, **vec_kw)
        if phase == "vec":
            return (vec,)

    qr = qr_tab[owner]                       # [B, 4, R]
    xover_rows = xover_tab[owner].astype(jnp.int32)
    gx_col = jnp.full((B,), xover, jnp.int32)
    full_kw = dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
                   a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
                   b_gap_ext=b_gap_ext, local_alignment=local_alignment,
                   indel_taboo_len=indel_taboo_len)
    packed, steps_rev = sw_full_cs_tpu.__wrapped__(
        lswin.astype(jnp.uint8), glen, qr, rlen, rx, ry,
        jnp.maximum(rl, 1), jnp.maximum(rw, 1), rev, xover_rows, gx_col,
        thresh, **full_kw)
    if phase == "full":
        return packed, steps_rev
    return vec, packed, steps_rev
