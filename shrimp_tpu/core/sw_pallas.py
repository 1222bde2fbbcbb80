"""Pallas Triton kernel for the vector Smith-Waterman filter (filter 2).

The reference's hottest loop is an SSE2 anti-diagonal wavefront scoring 8
read rows at a time (common/sw-vector.c:68-377). On the GPU the kernel
uses inter-task parallelism instead: every lane of a program scores one
independent (genome window, read) pair, so the DP needs no shuffles and
no intra-row gap resolution at all.

A program owns BLOCK pairs. It walks the genome columns j in a loop and
the read rows i unrolled inside it, so the previous column's H and E of
every row stay in registers and the F (vertical gap) chain is the
unrolled row order itself. Reads longer than STRIP_MAX rows run as
several strips; between strips the last row's H and F of every column
go through a small device buffer that the program owns.

Scores are bit-equal to sw_jax.sw_vector_batch: local affine SW where
gap-open charges open+extend, H clamped at 0, only cells with
i < rlen and j < glen count towards the best score, and colour-space
mode scores read row 0 against `g_row0` = lstocs(genome letters,
initbp) (sw-vector.c:108-146). A cell outside that rectangle only feeds
cells further down or right, which are outside it too, so the kernel
masks the best-score update alone.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .. import backend

NEG = -(2 ** 30)     # plain int: jnp scalars would be captured kernel consts

BLOCK = 128          # pairs per program: one per thread at NUM_WARPS=4
NUM_WARPS = 4
STRIP_MAX = 48       # read rows unrolled per strip (registers per thread)


def _strips(R: int):
    """Split rows [0, R) into near-equal strips of at most STRIP_MAX."""
    n = -(-R // STRIP_MAX)
    bounds = [R * k // n for k in range(n + 1)]
    return tuple(zip(bounds[:-1], bounds[1:]))


def _kernel(*refs, G, strips, m, mm, goa, gea, gob, geb, cs_mode, blk,
            barrier):
    if cs_mode:
        g_ref, r_ref, g0_ref, glen_ref, rlen_ref, out_ref, *buf = refs
    else:
        g_ref, r_ref, glen_ref, rlen_ref, out_ref, *buf = refs
        g0_ref = None
    lanes = pl.ds(pl.program_id(0) * blk, blk)
    glen = glen_ref[lanes]
    rlen = rlen_ref[lanes]
    zero = jnp.zeros((blk,), jnp.int32)
    best = zero

    for s, (i0, i1) in enumerate(strips):
        rows = range(i0, i1)
        rch = [r_ref[i, lanes].astype(jnp.int32) for i in rows]
        rvalid = [i < rlen for i in rows]

        def column(j, carry, s=s, rows=rows, rch=rch, rvalid=rvalid):
            hp, ep, htop, best = carry
            gch = g_ref[j, lanes].astype(jnp.int32)
            if s == 0:
                hup, fup = zero, None          # row -1: H = 0, F = NEG
            else:
                hb, fb = buf[2 * ((s - 1) % 2):2 * ((s - 1) % 2) + 2]
                hup, fup = hb[j, lanes], fb[j, lanes]
            ntop = hup                        # H[i0-1][j]: next diag
            diag = htop                       # H[i0-1][j-1]
            hs, es = [], []
            colmax = zero
            for t, i in enumerate(rows):
                if cs_mode and i == 0:
                    g0 = g0_ref[j, lanes].astype(jnp.int32)
                    sc = jnp.where(g0 == rch[t], m, mm)
                else:
                    sc = jnp.where(gch == rch[t], m, mm)
                e = jnp.maximum(hp[t] - goa, ep[t] - gea)
                if fup is None:
                    f = jnp.full((blk,), NEG, jnp.int32)
                else:
                    f = jnp.maximum(hup - gob, fup - geb)
                h = jnp.maximum(jnp.maximum(diag + sc, 0),
                                jnp.maximum(e, f))
                colmax = jnp.maximum(colmax, jnp.where(rvalid[t], h, 0))
                diag = hp[t]
                hup, fup = h, f
                hs.append(h)
                es.append(e)
            if s + 1 < len(strips):
                hb, fb = buf[2 * (s % 2):2 * (s % 2) + 2]
                hb[j, lanes] = hup
                fb[j, lanes] = fup
            best = jnp.maximum(best, jnp.where(j < glen, colmax, 0))
            return tuple(hs), tuple(es), ntop, best

        n = i1 - i0
        init = (tuple(zero for _ in range(n)),
                tuple(jnp.full((blk,), NEG, jnp.int32) for _ in range(n)),
                zero, best)
        _, _, _, best = jax.lax.fori_loop(0, G, column, init)
        if barrier and s + 1 < len(strips):
            pltriton.debug_barrier()   # strip rows stored, then read
    out_ref[lanes] = best


@functools.partial(jax.jit, static_argnames=(
    "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "cs_mode", "interpret"))
def sw_vector_batch_pallas(genome: jnp.ndarray, glen: jnp.ndarray,
                           read: jnp.ndarray, rlen: jnp.ndarray,
                           g_row0: jnp.ndarray = None,
                           *, match: int, mismatch: int,
                           a_gap_open: int, a_gap_ext: int,
                           b_gap_open: int, b_gap_ext: int,
                           cs_mode: bool = False,
                           interpret: bool = False) -> jnp.ndarray:
    """Drop-in for sw_jax.sw_vector_batch on the GPU. Any batch size:
    the batch pads to a whole number of BLOCK-pair programs with empty
    pairs (glen = rlen = 0, score 0). With `interpret` set the kernel
    runs on the Pallas interpreter, which is how the CPU tests reach
    it."""
    B, G = genome.shape
    R = read.shape[1]
    Bp = -(-B // BLOCK) * BLOCK

    def cols(x):
        # [B, L] -> [L, Bp]: a program's lanes read contiguous bytes
        return jnp.pad(x, ((0, Bp - B), (0, 0))).T

    strips = _strips(R)
    args = [cols(genome), cols(read)]
    if cs_mode:
        args.append(cols(g_row0))
    args += [jnp.pad(glen.astype(jnp.int32), (0, Bp - B)),
             jnp.pad(rlen.astype(jnp.int32), (0, Bp - B))]
    out_shape = [jax.ShapeDtypeStruct((Bp,), jnp.int32)]
    if len(strips) > 1:
        # strip-boundary H and F rows, double-buffered between strips
        out_shape += [jax.ShapeDtypeStruct((G, Bp), jnp.int32)] * 4
    kern = functools.partial(
        _kernel, G=G, strips=strips,
        m=int(match), mm=int(mismatch),
        goa=int(-(a_gap_open) + -(a_gap_ext)),
        gea=int(-(a_gap_ext)),
        gob=int(-(b_gap_open) + -(b_gap_ext)),
        geb=int(-(b_gap_ext)),
        cs_mode=cs_mode, blk=BLOCK, barrier=not interpret)
    outs = pl.pallas_call(
        kern,
        grid=(Bp // BLOCK,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="sw_vector_triton",
    )(*args)
    return outs[0][:B]


def sw_vector(gwin, glen, rwin, rlen, g_row0=None, *, vec_kernel: str,
              cs_mode: bool = False, **kw):
    """Vector SW scores by the kernel `vec_kernel` names (see backend);
    call inside a jitted function."""
    if vec_kernel == backend.VEC_TRITON:
        return sw_vector_batch_pallas.__wrapped__(
            gwin, glen, rwin, rlen, g_row0, cs_mode=cs_mode, **kw)
    from . import sw_jax
    return sw_jax.sw_vector_batch.__wrapped__(
        gwin, glen, rwin, rlen, g_row0, cs_mode=cs_mode, **kw)


@functools.partial(jax.jit, static_argnames=(
    "G", "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "vec_kernel"))
def sw_vector_ls_from_index(codes, gstart, glen, rtab, owner, rlen,
                            *, G: int, match: int, mismatch: int,
                            a_gap_open: int, a_gap_ext: int,
                            b_gap_open: int, b_gap_ext: int,
                            vec_kernel: str) -> jnp.ndarray:
    """Letter-space vector SW against the DEVICE-RESIDENT genome.

    Instead of gathering [B, G] genome windows on the host and shipping
    them per launch, the packed genome `codes` lives on the device once
    and only window start offsets (`gstart`, absolute) cross the host
    boundary. Read rows are gathered on-device too when `owner` is
    given: `rtab` is the per-batch read table (upload it once with
    device_put) and `owner` the per-candidate row index; with
    owner=None, `rtab` is already the per-candidate [B, R] row matrix.
    All argument shapes are launch-size constants so exactly one compile
    per (G, R) bucket happens. Windows crossing the genome end clip to
    the last base; `glen` masks them (same semantics as
    mapper._gather_rows).
    """
    jidx = jnp.arange(G, dtype=jnp.int32)[None, :]
    pos = jnp.clip(gstart.astype(jnp.int32)[:, None] + jidx, 0,
                   codes.shape[0] - 1)
    gwin = codes[pos]
    rwin = (rtab if owner is None
            else rtab[jnp.clip(owner.astype(jnp.int32), 0,
                               rtab.shape[0] - 1)])
    return sw_vector(gwin, glen, rwin, rlen, vec_kernel=vec_kernel,
                     match=match, mismatch=mismatch, a_gap_open=a_gap_open,
                     a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
                     b_gap_ext=b_gap_ext)


@functools.partial(jax.jit, static_argnames=(
    "G", "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "vec_kernel"))
def sw_vector_cs_from_index(cs_codes, cs_codes_rc, ls_codes, ls_codes_rc,
                            gstart, glen, eff_rc, rtab, owner, rlen, initbp,
                            *, G: int, match: int, mismatch: int,
                            a_gap_open: int, a_gap_ext: int,
                            b_gap_open: int, b_gap_ext: int,
                            vec_kernel: str) -> jnp.ndarray:
    """Colour-space vector SW against the DEVICE-RESIDENT genome planes.

    The CS vector SW scores the colour read against the genome's colour
    projection, except row 0 which re-derives the first colour from the
    genome letter and the read's initial base (sw-vector.c:108-146).
    Both colour planes (fw/rc) and both letter planes live on the device;
    per candidate only `gstart` (absolute, already strand-normalized on
    the host per reverse_hit, mapping.c:254-263), `eff_rc`, the read-row
    index and `initbp` cross the host boundary. g_row0 is computed
    on-device as COLOUR_MAT[genome_letter, initbp].
    """
    from .. import constants as C
    jidx = jnp.arange(G, dtype=jnp.int32)[None, :]
    pos = jnp.clip(gstart.astype(jnp.int32)[:, None] + jidx, 0,
                   cs_codes.shape[0] - 1)
    rcb = (eff_rc != 0)[:, None]
    gwin = jnp.where(rcb, cs_codes_rc[pos], cs_codes[pos])
    lswin = jnp.where(rcb, ls_codes_rc[pos], ls_codes[pos])
    cmat = jnp.asarray(C.COLOUR_MAT.reshape(-1))
    g_row0 = cmat[lswin.astype(jnp.int32) * 16
                  + initbp.astype(jnp.int32)[:, None]]
    rwin = rtab[jnp.clip(owner.astype(jnp.int32), 0, rtab.shape[0] - 1)]
    return sw_vector(gwin, glen, rwin, rlen, g_row0, vec_kernel=vec_kernel,
                     cs_mode=True, match=match, mismatch=mismatch,
                     a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                     b_gap_open=b_gap_open, b_gap_ext=b_gap_ext)
