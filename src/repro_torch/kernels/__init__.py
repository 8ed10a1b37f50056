"""Hand-written CUDA kernels for Hopper and their wrappers.

  lif_scan.py      csrc/lif.cu               fused LIF (f32 or bf16),
                                             with/without counts,
                                             with/without the residual,
                                             packed (words, no spikes);
                                             surrogate backward
  spike_matmul.py  csrc/spike_matmul_csr.cu  event-compacted CSR matmul, on
                                             f32 spikes or packed words,
                                             as an event walk
                                             (csrc/event_walk.cuh)
                   csrc/spike_matmul.cu      predicated (map-gated) matmul
                                             (its wide path a TMA ring,
                                             or csrc/tile_mma.cuh's
                                             cp.async ring)
                   csrc/apec_matmul_csr.cu   APEC's fused residual + overlap
                                             matmul on a union work list,
                                             on f32 spikes or packed words,
                                             as an event walk
                   csrc/spike_matmul_csr_pipe.cu, csrc/apec_matmul_csr_pipe.cu
                                             the CSR and APEC matmuls, the
                                             same sums, fed by
                                             csrc/tile_mma.cuh's cp.async
                                             ring (the routes picked on
                                             the card)
  apec_kernel.py   csrc/apec.cu              APEC overlap/residual on the
                                             spikes, or on words
  sdsa_kernel.py   csrc/sdsa.cu              packed OR-form attention
                   csrc/sdsa_causal.cu       causal (LM) status: the
                                             prefix-OR over tokens of
                                             packed kv words
  ref.py           plain PyTorch oracles
  ops.py           shape plumbing around the kernels
  dispatch.py      the backend registry model code calls

Each wrapper counts its launches (`launch_counts`), so a run can show
that its main path went through the kernels.
"""
from ._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
