"""Measurement tools of the port's kernels: `attn_roofline` (what each stage
of the K2 forward costs), `gn_stats` (formulations of K1's moment reduction)
and `fusion_overlap` (K5 against K1 followed by a library convolution).
Each has a `main(argv)` and runs as `python -m lunaris_orion_tpu_torch.tools.<name>`."""
