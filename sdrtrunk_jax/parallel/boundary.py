"""Float-pair jit boundaries for complex state.

The live entry points pass only real arrays across the host<->device and
jit boundaries; complex math happens INSIDE the compiled function. The
convention (kept for the live step's flat wire layout; XLA on the GPU
passes complex64 across the boundary itself, which chip_smoke.py checks
on the card):

  * every jit entry point takes/returns only real arrays
  * complex pytree leaves (carried DSP state: FIR histories, channelizer
    tails, PLL windows) are stored as float32 (..., 2) stacks and converted
    with lax.complex / stacking INSIDE the jit (fuses to nothing)

`pack_tree` / `unpack_tree` convert a pytree; `complex_safe` wraps a
step(x, state) -> (outputs, state) function into one whose state (and any
complex outputs) are packed.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["pack_array", "unpack_array", "pack_tree", "unpack_tree",
           "complex_safe"]

_MARKER_AXIS_NAME = "__iq__"


def pack_array(a):
    if jnp.iscomplexobj(a):
        return jnp.stack([a.real.astype(jnp.float32),
                          a.imag.astype(jnp.float32)], axis=-1)
    return a


def unpack_array(a, was_complex: bool):
    if was_complex:
        return jax.lax.complex(a[..., 0], a[..., 1]).astype(jnp.complex64)
    return a


def complex_flags(tree):
    """Pytree of bools marking complex leaves (from an unpacked tree)."""
    return jax.tree.map(lambda a: bool(jnp.iscomplexobj(a)), tree)


def pack_tree(tree):
    return jax.tree.map(pack_array, tree)


def unpack_tree(tree, flags):
    return jax.tree.map(unpack_array, tree, flags)


def complex_safe(step_fn, init_state):
    """Wrap step(x, state)->(outputs, state) so state crosses jit
    boundaries as float pairs. Returns (wrapped_fn, packed_init_state).

    `init_state` is either a zero-argument callable building the state
    (built INSIDE one jitted call that returns only float pairs), or a
    concrete example state.
    """
    if callable(init_state):
        shapes = jax.eval_shape(init_state)
        flags = jax.tree.map(lambda a: jnp.issubdtype(a.dtype, jnp.complexfloating),
                             shapes)
        packed0 = jax.jit(lambda: pack_tree(init_state()))()
    else:
        flags = complex_flags(init_state)
        packed0 = pack_tree(init_state)

    def wrapped(x, packed_state, *extra):
        state = unpack_tree(packed_state, flags)
        outputs, new_state = step_fn(x, state, *extra)
        return jax.tree.map(pack_array, outputs), pack_tree(new_state)

    return wrapped, packed0
