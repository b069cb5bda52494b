"""The TPU round's kernel experiments, ported to the card.

One module per script of ``benchmarks/`` whose Pallas kernel has a CUDA
counterpart here, under the same name; each ``main()`` runs at its
script's shapes on the card and prints, per variant, the kernel's
CUDA-event time, its check against the plain version, the bound and the
rate, then one JSON line:

    python -m allset_tpu_torch.experiments.pallas_segsum_proto   # B1
    python -m allset_tpu_torch.experiments.exp_nbuf              # B2
    python -m allset_tpu_torch.experiments.exp_acc2              # B3
    python -m allset_tpu_torch.experiments.exp_onehot            # B4
    python -m allset_tpu_torch.experiments.exp_segsum_ablate     # B6, B5, B7
    python -m allset_tpu_torch.experiments.exp_autopipe          # B8
    python -m allset_tpu_torch.experiments.exp_fused_gather      # B11, B10, B9

``--device cpu`` runs the plain versions at a small size.
"""
