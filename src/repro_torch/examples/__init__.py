"""The reference's five example scripts on the port, each runnable as

    python -m repro_torch.examples.<name> [--device cpu] [arguments]

  quickstart        a spiking LM's loss and gradients, event sparsity, APEC
                    and the O(d) SDSA decode state against a KV cache
  segmentation      spiking SegNet trained on the synthetic lane dataset
  train_spiking_lm  a spiking LM trained with checkpoints and a resume
  serve_spiking_lm  continuous-batching serving, spiking and dense
  long_context      decoding at 500k-token positions with the O(d) state

Each takes the reference script's arguments plus ``--device`` (the card
by default; ``cpu`` runs the kernels' plain versions) and prints the
reference's lines. Weights come from the port's own seeded init, so the
numbers are not the reference's.
"""
