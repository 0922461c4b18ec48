"""sdrtrunk_jax — a JAX software-defined-radio trunked-protocol framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of sdrtrunk
(smyers119/sdrtrunk, Java): wideband IQ -> polyphase channelizer -> per-channel
demodulation (NBFM/AM/C4FM/4FSK/LTR) -> symbol recovery -> protocol framing
(P25 Phase 1/2, DMR, LTR, MPT1327, Passport) -> messages/events/audio.

Architecture (nothing is a port; see SURVEY.md):
  * data plane = batched array pipeline:
      IQ[time] -> channelize[block, channel] -> demod[channel, time']
               -> symbols[channel, sym] -> bits -> messages/audio
  * feedback loops (PLL, symbol timing, AGC, squelch) = lax.scan carried state,
    batched across channels (a GPU kernel runs the symbol-recovery loop)
  * control plane (configs, framers, message parsing, events) = host Python
  * multi-device = jax.sharding.Mesh over devices with channel-group
    sharding and overlap-save halo exchange for time-block sharding
"""

__version__ = "0.1.0"
