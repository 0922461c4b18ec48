"""Multi-device SPMD pipeline: time-sharded ingest -> channelize ->
all-to-all transpose -> channel-sharded demod.

The reference has no distributed layer (one JVM, SURVEY.md section 2.8); this
is the batched design replacing its thread-per-stage concurrency:

  * wideband IQ arrives TIME-SHARDED across the mesh (each host/chip ingests
    a contiguous slice of the capture) — the "sequence parallel" axis
  * each device channelizes its slice locally after an overlap-save HALO
    exchange (lax.ppermute) of the T*M filter history from its left
    neighbor — the only inter-device traffic the filter bank needs
  * a single all_to_all transposes (channels, local-time) so each device
    holds ALL time for its CHANNEL GROUP — the "tensor parallel" axis
  * per-channel demod chains then run vmapped over the local channel group
    with zero further communication

The mesh is one axis; every device reaches every other (NVLink on a
multi-GPU host), so the axis order follows the algorithm only. A channel
count that does not divide over the mesh is padded with copies of the last
channel, which are sliced away from the output.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dsp.channelizer import Channelizer, _channelize_core
from ..dsp.extract import ChannelPlan

__all__ = ["ShardedChannelizerPipeline"]

TWO_PI = 2.0 * np.pi


@dataclass
class ShardedChannelizerPipeline:
    """Channelize + extract across a 1-D device mesh ("shard" axis).

    Produces per-channel baseband streams sharded by channel group; feed
    them to a vmapped decoder (still under the same jit) for zero-copy
    chaining.
    """
    channelizer: Channelizer
    plan: ChannelPlan
    mesh: Mesh
    axis: str = "shard"

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def padded_count(self) -> int:
        """Channel rows computed: plan.count rounded up to the mesh."""
        n = self.n_shards
        return -(-self.plan.count // n) * n

    def _padded(self, a: np.ndarray) -> np.ndarray:
        """Per-channel plan array padded to padded_count rows by
        repeating the last channel."""
        a = np.asarray(a)
        pad = self.padded_count - a.shape[0]
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

    def input_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(self.axis))

    def output_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(self.axis, None))

    def build(self):
        """Returns a jitted fn: x (S*L,) time-sharded -> (C, K) streams
        sharded by channel group (C rows split over devices)."""
        ch = self.channelizer
        m = ch.channels
        hist = ch.taps_per_channel * m
        hmat = jnp.asarray(ch.hmat)
        bins = jnp.asarray(self._padded(self.plan.bins))
        step = jnp.asarray(self._padded(
            TWO_PI * self.plan.offsets / self.plan.rate), jnp.float32)
        n_shards = self.n_shards
        axis = self.axis

        def shard_fn(x_local):
            # x_local: (1, L) leading axis is the sharded axis collapsed to 1
            x_local = x_local[0]
            L = x_local.shape[0]
            idx = jax.lax.axis_index(axis)

            # --- overlap-save halo from left neighbor (ppermute ring) ---
            tail = x_local[-hist:]
            perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            halo = jax.lax.ppermute(tail, axis, perm)
            halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)

            # --- local channelize ---
            y = _channelize_core(jnp.concatenate([halo, x_local]), hmat, m)
            k_local = y.shape[0]
            # global block parity fix: _channelize_core numbers blocks from 0
            # locally; odd global offset would flip the (-1)^{mk} sign. L is
            # a multiple of M so k_local is even and parity is consistent.

            # --- extract requested channels, mixer phase at global time ---
            # bins is (C, 2): two-bin wide channels are joined by the PR
            # synthesizer rotator indexed at the GLOBAL block position so
            # shard boundaries stay phase-continuous (dsp/synthesizer.py)
            from ..dsp.synthesizer import _ROT4
            lo = y[:, bins[:, 0]]                        # (K_local, C)
            hi = y[:, bins[:, 1]]
            rot = jnp.asarray(_ROT4)[
                (idx * k_local + jnp.arange(k_local)) % 4]
            z = rot[:, None] * lo - jnp.conj(rot)[:, None] * hi
            streams = jnp.where((bins[:, 0] != bins[:, 1])[None, :],
                                z, lo).T                 # (C, K_local)
            base = (idx * k_local).astype(jnp.float32)
            nn = base + jnp.arange(k_local, dtype=jnp.float32)[None, :]
            mixer = jnp.exp(-1j * (step[:, None] * nn)).astype(jnp.complex64)
            streams = streams * mixer

            # --- transpose: channel groups across devices, full time ---
            c = streams.shape[0]
            grouped = streams.reshape(n_shards, c // n_shards, k_local)
            # split_axis=0 scatters group g to device g; received pieces
            # stack as a new axis at position 1 in source order ->
            # (C/S, S, K_local), source order == time order.
            full = jax.lax.all_to_all(
                grouped, axis, split_axis=0, concat_axis=1, tiled=False)
            return full.reshape(1, c // n_shards, n_shards * k_local)

        fn = jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=P(self.axis),
            out_specs=P(self.axis, None, None),
        )

        @jax.jit
        def run(x):
            s = n_shards
            x2 = x.reshape(s, -1)
            out = fn(x2)
            return out.reshape(self.padded_count, -1)[:self.plan.count]

        return run

    # ---------------------------------------------------------- streaming

    def init_carry(self) -> dict:
        """Zero carry for build_streaming(): channelizer history (the
        taps_per_channel*M raw samples preceding the next chunk), the
        per-channel mixer phase and the two-bin rotator index — exactly
        the state the single-device streaming path carries (Channelizer
        state + extract_channels phase), so sharded streaming equals
        single-device streaming chunk for chunk."""
        ch = self.channelizer
        hist = ch.taps_per_channel * ch.channels
        return {
            "tail": jnp.zeros((hist,), jnp.complex64),
            "mixer_phase": jnp.zeros((self.plan.count,), jnp.float32),
            "rot_k": jnp.asarray(0, jnp.int32),
        }

    def build_streaming(self):
        """Returns a jitted fn: (x (S*L,), carry) -> ((C, K) streams,
        new carry). Unlike build(), consecutive calls are one continuous
        stream: device 0's halo comes from the previous chunk's tail and
        the mixer/rotator run at the global stream position (VERDICT r4
        gap 4 — the one-shot pipeline zeroed the left edge and restarted
        mixer phase every call; reference streaming continuity:
        ComplexPolyphaseChannelizerM2.java:200-228 carry buffer)."""
        ch = self.channelizer
        m = ch.channels
        hist = ch.taps_per_channel * m
        hmat = jnp.asarray(ch.hmat)
        bins = jnp.asarray(self._padded(self.plan.bins))
        step_np = self._padded(TWO_PI * self.plan.offsets / self.plan.rate
                               ).astype(np.float32)
        step = jnp.asarray(step_np)
        wide = jnp.asarray(self._padded(self.plan.wide))
        n_shards = self.n_shards
        axis = self.axis

        from ..dsp.synthesizer import _ROT4

        def shard_fn(x_local, tail, mixer_phase, rot_k):
            x_local = x_local[0]
            idx = jax.lax.axis_index(axis)

            # halo: left neighbor's tail; device 0 gets the carry tail
            tail_l = x_local[-hist:]
            perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            halo = jax.lax.ppermute(tail_l, axis, perm)
            halo = jnp.where(idx == 0, tail, halo)

            y = _channelize_core(jnp.concatenate([halo, x_local]),
                                 hmat, m)
            k_local = y.shape[0]
            # k_local is even (L multiple of M), so the local block
            # parity matches the global one on every shard and chunk

            lo = y[:, bins[:, 0]]
            hi = y[:, bins[:, 1]]
            g0 = idx * k_local
            rot = jnp.asarray(_ROT4)[
                (rot_k + g0 + jnp.arange(k_local)) % 4]
            z = rot[:, None] * lo - jnp.conj(rot)[:, None] * hi
            streams = jnp.where(wide[None, :], z, lo).T    # (C, K_local)
            # identical arithmetic to extract_channels:139 at the global
            # index (one f32 multiply + add), so chunks are bit-equal to
            # the single-device streaming path
            nn = (g0.astype(jnp.float32)
                  + jnp.arange(k_local, dtype=jnp.float32))[None, :]
            angles = mixer_phase[:, None] + step[:, None] * nn
            streams = streams * jnp.exp(-1j * angles).astype(
                jnp.complex64)

            c = streams.shape[0]
            grouped = streams.reshape(n_shards, c // n_shards, k_local)
            full = jax.lax.all_to_all(
                grouped, axis, split_axis=0, concat_axis=1, tiled=False)
            return full.reshape(1, c // n_shards, n_shards * k_local)

        fn = jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(self.axis), P(), P(), P()),
            out_specs=P(self.axis, None, None),
        )

        @jax.jit
        def run(x, carry):
            x2 = x.reshape(n_shards, -1)
            phase = carry["mixer_phase"]
            pad = self.padded_count - phase.shape[0]
            phase = jnp.concatenate([phase, jnp.repeat(phase[-1:], pad)])
            out = fn(x2, carry["tail"], phase, carry["rot_k"])
            k_total = 2 * x.shape[0] // m
            c = self.plan.count
            new_carry = {
                "tail": x[-hist:],
                "mixer_phase": jnp.mod(
                    carry["mixer_phase"] + step[:c] * k_total, TWO_PI),
                "rot_k": (carry["rot_k"] + k_total) % 4,
            }
            return out.reshape(self.padded_count, -1)[:c], new_carry

        return run
