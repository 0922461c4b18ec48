"""Bank host layer in a WORKER PROCESS: unpack + bank-frame + route in
a separate interpreter so the live loop's Python/numpy host work runs
truly parallel to the parent's device management.

Why: the pipelined orchestrator already splits upload / compute+D2H /
framing / routing across threads, but CPython's GIL serializes the
Python halves — measured on the 2-core bench host, DMR framing+routing
(~0.5-0.7 s per 0.41 s chunk in-process) caps the 1023-carrier live
loop well below realtime although the device step is far shorter.
This is the analog of the reference's per-stage thread pool
(util/ThreadPool.java) done against the GIL: one worker process owns
the ENTIRE host message layer (bank framer, per-slot decoder states,
traffic manager, audio assembly), and the parent exchanges compact
per-chunk messages with it:

  parent -> worker:  packed device transfer (bytes), active mask, now
  worker -> parent:  per-slot frame counts, decode-event deltas,
                     completed AudioSegments, traffic ACTIONS
                     (activate/teardown requests), control state

Traffic following still closes through the parent: the worker's
traffic manager emits actions, the parent applies them to the DEVICE
slot plan (_tune + state reset) and mirrors them back with "reset"
messages — one chunk of grant latency, exactly like the in-process
pipelined path. Opt-in via Orchestrator(host_process=True); digital
bank modes only (P25P1/C4FM/LSM, DMR, P25P2).

Measured on the 2-core bench host: parity with the in-process tier
(DMR 0.49x vs 0.52x, P25P2 0.33x vs 0.37x) — both cores were already
saturated, so the IPC (~1 MB in + events/audio out per chunk) offsets
the GIL relief there. The tier is for production hosts with spare
cores, where the host layer gets a core of its own; correctness is
asserted identical to in-process in tests/test_orchestrator_bank.py.
"""
from __future__ import annotations

import multiprocessing as mp
import threading

import numpy as np

__all__ = ["ProcessBankHost"]


def _build_processor(decoder: str, slots: int, control_slots, codec,
                     traffic):
    from .bank_processor import (DMRBankProcessor, P25P1BankProcessor,
                                 P25P2BankProcessor)
    cls = {"dmr": DMRBankProcessor,
           "p25p2": P25P2BankProcessor}.get(decoder, P25P1BankProcessor)
    return cls(slots, control_slots=set(control_slots), traffic=traffic,
               codec=codec)


def _worker_main(conn, decoder: str, slots: int, control_slots,
                 codec, protocol_label: str, idle_teardown: float,
                 bank_cap: int) -> None:
    from .traffic import TrafficChannelManager

    actions: list = []
    traffic = TrafficChannelManager(
        protocol_label, idle_teardown_seconds=idle_teardown,
        on_activate=lambda freq, ids, kind=None:
            actions.append(("activate", freq, ids, kind)),
        on_teardown=lambda freq: actions.append(("teardown", freq)))
    proc = _build_processor(decoder, slots, control_slots, codec,
                            traffic)
    events_sent = 0

    def split(buf: np.ndarray):
        c, cap = slots, bank_cap
        q, h = cap // 4, cap // 8
        dib4 = buf[: c * q].reshape(c, q)
        hits = buf[c * q: c * (q + h)].reshape(c, h)
        counts = buf[c * (q + h): c * (q + h) + 4 * c].view(np.int32)
        pll = float(buf[-4:].view(np.float32)[0])
        return dib4, hits, counts, pll

    while True:
        msg = conn.recv()
        op = msg[0]
        if op == "chunk":
            _, raw, active_bytes, now, control_index = msg
            buf = np.frombuffer(raw, np.uint8)
            dib4, hits, counts, pll = split(buf)
            msgs = proc.frame_chunk(dib4, counts, hits)
            active = np.frombuffer(active_bytes, bool)
            per_slot = proc.route(msgs, counts, active, now)
            # traffic activity aging + teardown checks live here with
            # the manager
            for s in np.nonzero(per_slot)[0]:
                if int(s) != control_index and active[s]:
                    traffic.process_activity(
                        proc_slot_freqs.get(int(s), 0.0), now)
            traffic.check_teardown(now)
            audio = []
            for s in np.nonzero(active)[0]:
                audio.extend(proc.drain_audio(int(s)))
            new_events = traffic.events[events_sent:]
            events_sent = len(traffic.events)
            framer = getattr(proc, "framer", None)
            degraded = {
                k: int(getattr(framer, k, 0) or 0)
                for k in ("deferred_hard_bch", "expired_pending",
                          "dropped_hard_rs")
                if getattr(framer, k, 0)} if framer is not None else {}
            if framer is not None and framer.pending:
                degraded["pending_frames"] = len(framer.pending)
            reply = {
                "per_slot": per_slot.tobytes(),
                "actions": actions[:],
                "events": new_events,
                "audio": audio,
                "pll": pll,
                "control_state": proc.channel_state(control_index),
                "unknown_opcodes": sum(m.unknown_opcodes
                                       for m in proc.metrics),
                "degraded": degraded,
            }
            actions.clear()
            conn.send(("result", reply))
        elif op == "reset":
            _, slot, preload, extra, freq = msg
            proc_slot_freqs[slot] = freq
            proc.reset_slot(slot, preload=preload, **(extra or {}))
            conn.send(("ok",))
        elif op == "flush":
            _, slot, now = msg
            proc.flush(slot, now)
            conn.send(("audio", proc.drain_audio(slot)))
        elif op == "frame_counts":
            conn.send(("counts", proc.frame_counts.tobytes()))
        elif op == "scramble_key":
            fn = getattr(proc, "scramble_key", None)
            conn.send(("key", fn() if fn is not None else None))
        elif op == "stop":
            conn.send(("bye",))
            return


proc_slot_freqs: dict[int, float] = {}   # worker-side slot -> frequency


class ProcessBankHost:
    """Parent-side handle: strict request-response over one Pipe,
    guarded by a lock so the download thread's chunk round-trips and
    the main thread's control messages never interleave."""

    def __init__(self, decoder: str, slots: int, control_slots,
                 codec, protocol_label: str, idle_teardown: float,
                 bank_cap: int):
        # spawn: a forked child would inherit the parent's initialized
        # JAX state (device handles, runtime threads) — the worker is
        # pure numpy and must never touch it (nor open the card a second
        # time)
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child, decoder, slots, sorted(control_slots), codec,
                  protocol_label, idle_teardown, bank_cap),
            daemon=True)
        self._proc.start()
        child.close()
        self._lock = threading.Lock()
        self.slots = slots
        self.frame_counts = np.zeros(slots, np.int64)

    def _rpc(self, msg):
        with self._lock:
            self._conn.send(msg)
            return self._conn.recv()

    def process_chunk(self, packed: np.ndarray, active: np.ndarray,
                      now: float, control_index: int) -> dict:
        tag, reply = self._rpc(("chunk", packed.tobytes(),
                                np.asarray(active, bool).tobytes(),
                                now, control_index))
        assert tag == "result"
        per_slot = np.frombuffer(reply["per_slot"], np.int64)
        self.frame_counts += per_slot
        reply["per_slot"] = per_slot
        return reply

    def reset_slot(self, slot: int, preload=None, extra=None,
                   frequency: float = 0.0) -> None:
        self._rpc(("reset", slot, preload, extra, frequency))

    def flush(self, slot: int, now: float) -> list:
        tag, audio = self._rpc(("flush", slot, now))
        return audio

    def scramble_key(self):
        tag, key = self._rpc(("scramble_key",))
        return key

    def close(self) -> None:
        try:
            self._rpc(("stop",))
        except (BrokenPipeError, EOFError):
            pass
        self._proc.join(timeout=5.0)
        if self._proc.is_alive():
            self._proc.terminate()

    def __del__(self):
        try:
            if self._proc.is_alive():
                self._proc.terminate()
        except Exception:       # noqa: BLE001 — interpreter teardown
            pass
