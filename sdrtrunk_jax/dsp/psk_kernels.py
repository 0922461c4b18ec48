"""GPU kernels for batched DQPSK symbol recovery (Pallas, Triton route).

The symbol-recovery loop (dsp/psk.py) is sequential in time and
independent across channels. XLA can only run it as a while loop whose
every step is one or more kernel launches over all channels; here the
time loop runs INSIDE one kernel instead:

  * each program owns `block` channels; the grid spreads the channel axis
    over the streaming multiprocessors and nothing is carried between
    programs;
  * the delay-line window (W complex taps) and the loop scalars live in
    registers as tuples of (block,) vectors, shifted by renaming;
  * each step reads one coalesced row of the time-major (T, C) input
    (the next row is loaded one step ahead so its latency overlaps the
    current step's arithmetic) and writes one row of packed symbols
    (dibit | valid << 2, int8);
  * the interpolator arm is a per-lane read of the (129, 8) tap table.

The two loops share this skeleton and differ only in their step:
`_dd_step` mirrors DQPSKDemodulator._step (C4FM and DMR banks),
`_gardner_step` mirrors GardnerDQPSKDemodulator._step (LSM and P25
Phase 2 banks), op for op. The XLA scans in dsp/psk.py stay the
reference; tests run these kernels in Pallas interpret mode on the CPU
against them.

Padding rule: the channel axis is padded to a multiple of `block` with
lanes that carry the demodulator's initial state (finite arithmetic);
their outputs are sliced away. The time axis takes any length.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .interpolator import CENTER, NSTEPS, NTAPS

__all__ = ["kernel_batched", "DEFAULT_BLOCK"]

# channels per program: one warp. Chosen on the card by the block sweep in
# chip_smoke.py (PERF.md records the sweep).
DEFAULT_BLOCK = 32

_SQRT_HALF = math.sqrt(0.5)
TWO_PI = 2.0 * math.pi


def _wrap(p):
    p = jnp.where(p > TWO_PI, p - TWO_PI, p)
    return jnp.where(p < -TWO_PI, p + TWO_PI, p)


def _arm(bank, mu):
    """Interpolator taps for fractional mu (per lane): row
    int(NSTEPS * mu) of the (NSTEPS + 1, NTAPS) table."""
    idx = jnp.clip((NSTEPS * mu).astype(jnp.int32), 0, NSTEPS)
    return [bank[idx, j] for j in range(NTAPS)]


def _dot8(taps, w):
    acc = taps[0] * w[0]
    for j in range(1, NTAPS):
        acc = acc + taps[j] * w[j]
    return acc


def _diff_norm(s_re, s_im, p_re, p_im):
    """normalize(s * conj(p)) with the zero guard of psk._normalize."""
    dr = s_re * p_re + s_im * p_im
    di = s_im * p_re - s_re * p_im
    m2 = dr * dr + di * di
    inv = jax.lax.rsqrt(jnp.maximum(m2, 1e-30))
    good = m2 > 1e-24
    return jnp.where(good, dr * inv, 0.0), jnp.where(good, di * inv, 0.0)


def _quadrant(ci, cq):
    i_pos = ci > 0.0
    q_pos = cq > 0.0
    dibit = jnp.where(q_pos, jnp.where(i_pos, 0, 1),
                      jnp.where(i_pos, 2, 3)).astype(jnp.int32)
    sgn_i = jnp.where(i_pos, 1.0, -1.0)
    sgn_q = jnp.where(q_pos, 1.0, -1.0)
    return dibit, i_pos, _SQRT_HALF * (cq * sgn_i - ci * sgn_q)


def _mix(xr, xi, ph, fr):
    phase = _wrap(ph + fr)
    c, s = jnp.cos(phase), jnp.sin(phase)
    return phase, xr * c - xi * s, xr * s + xi * c


def _pll(phase, fr, perr, cfg):
    perr = jnp.clip(perr, -0.5, 0.5)
    freq = fr + cfg["beta"] * perr
    phase2 = _wrap(phase + freq + cfg["alpha"] * perr)
    return phase2, jnp.clip(freq, -cfg["max_pll_freq"], cfg["max_pll_freq"])


def _dd_step(bank, xr, xi, win_re, win_im, scal, cfg):
    """DQPSKDemodulator._step for one row. scal = (sp, dsps, ph, fr,
    prev_preceding re/im, prev_current re/im)."""
    sp, dsps, ph, fr, pp_re, pp_im, pc_re, pc_im = scal
    phase, mr, mi = _mix(xr, xi, ph, fr)
    win_re = win_re[1:] + (mr,)
    win_im = win_im[1:] + (mi,)
    sp = sp - 1.0
    has = sp < 1.0

    taps = _arm(bank, jnp.clip(sp, 0.0, 1.0))
    cur_re = _dot8(taps, win_re)
    cur_im = _dot8(taps, win_im)
    prec_re, prec_im = win_re[CENTER], win_im[CENTER]

    _, pqn = _diff_norm(prec_re, prec_im, pp_re, pp_im)
    cin, cqn = _diff_norm(cur_re, cur_im, pc_re, pc_im)
    dibit, i_pos, quad = _quadrant(cin, cqn)
    polarity = jnp.where(i_pos, jnp.where(pqn > cqn, 1.0, -1.0),
                         jnp.where(pqn < cqn, 1.0, -1.0))
    err = jnp.clip(quad, -0.3, 0.3)
    err = jnp.where(jnp.isnan(err), 0.0, err)
    terr = err * polarity

    detected = jnp.clip(dsps + terr * cfg["dsps_gain"],
                        cfg["sps_min"], cfg["sps_max"])
    sp_new = sp + detected + terr * cfg["g"]
    phase2, freq = _pll(phase, fr, -err, cfg)
    new = (jnp.where(has, sp_new, sp), jnp.where(has, detected, dsps),
           jnp.where(has, phase2, phase), jnp.where(has, freq, fr),
           jnp.where(has, prec_re, pp_re), jnp.where(has, prec_im, pp_im),
           jnp.where(has, cur_re, pc_re), jnp.where(has, cur_im, pc_im))
    return dibit, has, win_re, win_im, new


def _interp(bank, win_re, win_im, offset, bases):
    """GardnerDQPSKDemodulator._interp for one row: the integer part of
    `offset` picks the 8-tap base among the statically feasible `bases`
    (lanes outside them read zeros, as in the scan's masked gather), the
    fractional part picks the arm."""
    w = len(win_re)
    k = jnp.floor(offset).astype(jnp.int32)
    taps = _arm(bank, offset - k.astype(jnp.float32))
    base = jnp.clip(k, 0, w - 8)
    zero = jnp.zeros_like(offset)
    w8_re, w8_im = [], []
    for j in range(NTAPS):
        re, im = zero, zero
        for b in bases:
            sel = base == b
            re = jnp.where(sel, win_re[b + j], re)
            im = jnp.where(sel, win_im[b + j], im)
        w8_re.append(re)
        w8_im.append(im)
    return _dot8(taps, w8_re), _dot8(taps, w8_im)


def _gardner_step(bank, xr, xi, win_re, win_im, scal, cfg):
    """GardnerDQPSKDemodulator._step for one row. scal = (sp, dsps, ph,
    fr, prev_mid_sample, prev_cur_sample, prev_cur_symbol re/im)."""
    sp, dsps, ph, fr, pm_re, pm_im, pc_re, pc_im, ps_re, ps_im = scal
    phase, mr, mi = _mix(xr, xi, ph, fr)
    win_re = win_re[1:] + (mr,)
    win_im = win_im[1:] + (mi,)
    sp = sp - 1.0
    has = sp < 1.0

    mid_re, mid_im = _interp(bank, win_re, win_im, jnp.clip(sp, 0.0, 1.0),
                             cfg["mid_bases"])
    cur_re, cur_im = _interp(bank, win_re, win_im, dsps / 2.0,
                             cfg["cur_bases"])
    ms_re, ms_im = _diff_norm(mid_re, mid_im, pm_re, pm_im)
    cs_re, cs_im = _diff_norm(cur_re, cur_im, pc_re, pc_im)

    terr = (ps_re - cs_re) * ms_re + (ps_im - cs_im) * ms_im
    terr = jnp.clip(jnp.where(jnp.isnan(terr), 0.0, terr), -0.3, 0.3)
    dibit, _, quad = _quadrant(cs_re, cs_im)
    perr = -quad
    perr = jnp.clip(jnp.where(jnp.isnan(perr), 0.0, perr), -0.3, 0.3)

    detected = jnp.clip(dsps + terr * cfg["dsps_gain"],
                        cfg["sps_min"], cfg["sps_max"])
    sp_new = sp + detected + terr * cfg["g"]
    phase2, freq = _pll(phase, fr, perr, cfg)
    new = (jnp.where(has, sp_new, sp), jnp.where(has, detected, dsps),
           jnp.where(has, phase2, phase), jnp.where(has, freq, fr),
           jnp.where(has, mid_re, pm_re), jnp.where(has, mid_im, pm_im),
           jnp.where(has, cur_re, pc_re), jnp.where(has, cur_im, pc_im),
           jnp.where(has, cs_re, ps_re), jnp.where(has, cs_im, ps_im))
    return dibit, has, win_re, win_im, new


def _loop_kernel(x_re, x_im, bank, w_re0, w_im0, s0,
                 out, w_re1, w_im1, s1, *, step, t_len, block, cfg):
    """The whole time loop for one block of channels."""
    cols = pl.ds(pl.program_id(0) * block, block)
    w = w_re0.shape[0]
    win_re = tuple(w_re0[j, cols] for j in range(w))
    win_im = tuple(w_im0[j, cols] for j in range(w))
    scal = tuple(s0[k, cols] for k in range(s0.shape[0]))

    def body(t, carry):
        win_re, win_im, scal, xr, xi = carry
        nxt = jnp.minimum(t + 1, t_len - 1)
        xr_next, xi_next = x_re[nxt, cols], x_im[nxt, cols]
        dibit, has, win_re, win_im, scal = step(
            bank, xr, xi, win_re, win_im, scal, cfg)
        out[t, cols] = (dibit | (has.astype(jnp.int32) << 2)
                        ).astype(jnp.int8)
        return win_re, win_im, scal, xr_next, xi_next

    win_re, win_im, scal, _, _ = jax.lax.fori_loop(
        0, t_len, body, (win_re, win_im, scal, x_re[0, cols], x_im[0, cols]))
    for j in range(w):
        w_re1[j, cols] = win_re[j]
        w_im1[j, cols] = win_im[j]
    for k, v in enumerate(scal):
        s1[k, cols] = v


def _state_rows(state) -> list[tuple[str, bool]]:
    """(field, is_complex) for every non-window state leaf, in order."""
    return [(f, jnp.iscomplexobj(getattr(state, f)))
            for f in state._fields if f != "window"]


def kernel_batched(demod, x: jnp.ndarray, state, *,
                   block: int = DEFAULT_BLOCK, interpret: bool = False):
    """demod.batched semantics through the GPU kernel.

    x: (C, T) complex; state: demod state with leading-C leaves (window
    (C, W)). Returns (dibits (C, T) int32, valid (C, T) bool, state).
    interpret=True runs the kernel in the Pallas interpreter (CPU tests).
    The kernel has no partitioning rule: on a mesh, call it per device
    inside jax.shard_map (check_vma=False).
    """
    from .psk import GardnerDQPSKDemodulator
    gardner = isinstance(demod, GardnerDQPSKDemodulator)
    if block < 1 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    c, t = x.shape
    if t == 0:
        return (jnp.zeros((c, 0), jnp.int32), jnp.zeros((c, 0), bool),
                state)
    cp = -(-c // block) * block
    cfg = dict(
        sps_min=demod.samples_per_symbol * (1.0 - demod.max_deviation),
        sps_max=demod.samples_per_symbol * (1.0 + demod.max_deviation),
        g=demod.sample_counter_gain, dsps_gain=demod.dsps_gain,
        alpha=demod.alpha, beta=demod.beta, max_pll_freq=demod.max_pll_freq)
    if gardner:
        cfg.update(mid_bases=demod.mid_bases, cur_bases=demod.cur_bases)

    # pad lanes carry the initial state so their arithmetic stays finite
    init = demod.init_state()
    pad = cp - c

    def padded(leaf, init_leaf):
        fill = jnp.broadcast_to(init_leaf, (pad,) + init_leaf.shape)
        return jnp.concatenate([leaf, fill.astype(leaf.dtype)])

    rows = _state_rows(state)
    scal = []
    for f, is_complex in rows:
        v = padded(getattr(state, f), getattr(init, f))
        scal += ([v.real, v.imag] if is_complex else [v])
    s0 = jnp.stack([r.astype(jnp.float32) for r in scal])      # (S, Cp)
    win = padded(state.window, init.window).T                  # (W, Cp)
    xt = jnp.pad(x.T, ((0, 0), (0, pad)))                      # (T, Cp)
    bank = jnp.asarray(np.asarray(demod.bank), jnp.float32)    # (129, 8)
    w = win.shape[0]

    kernel = partial(_loop_kernel, step=_gardner_step if gardner
                     else _dd_step, t_len=t, block=block, cfg=cfg)
    f32 = jnp.float32
    packed, w_re, w_im, s1 = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((t, cp), jnp.int8),
                   jax.ShapeDtypeStruct((w, cp), f32),
                   jax.ShapeDtypeStruct((w, cp), f32),
                   jax.ShapeDtypeStruct(s0.shape, f32)],
        grid=(cp // block,),
        interpret=interpret,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        name="gardner_loop" if gardner else "dqpsk_loop",
    )(xt.real.astype(f32), xt.imag.astype(f32), bank,
      win.real.astype(f32), win.imag.astype(f32), s0)

    packed = packed[:, :c].T
    dibits = (packed & 3).astype(jnp.int32)
    valid = (packed >> 2) > 0
    new = {"window": jax.lax.complex(w_re[:, :c], w_im[:, :c]).T}
    i = 0
    for f, is_complex in rows:
        if is_complex:
            new[f] = jax.lax.complex(s1[i, :c], s1[i + 1, :c])
            i += 2
        else:
            new[f] = s1[i, :c]
            i += 1
    return dibits, valid, type(state)(**new)
