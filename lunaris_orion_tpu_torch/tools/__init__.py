"""Measurement and parity tools of the port. Each has a `main(argv)` and runs
as `python -m lunaris_orion_tpu_torch.tools.<name>`; `--device` is cuda
unless the CPU is asked for (a request for cuda without a card raises).

Kernel measurements: `attn_roofline` (what each stage of the K2 forward
costs), `gn_stats` (formulations of K1's moment reduction) and
`fusion_overlap` (K5 against K1 followed by a library convolution).

Long parity runs against the JAX package (`_parity`): `parity_curves` (the
VAE step, 300 steps of batch 16, deterministic and sampled), `parity_hybrid`
(the product hybrid step, 200 steps of batch 8, `--attn_window 0|256`) and
`window_dynamics` (the full-width bf16 step, global against a 256-token
window, from one init). The JAX curves they hold the port to, and the init
they start from, are committed in `parity_ref/`; they are made on the CPU by

    JAX_PLATFORMS=cpu python tests/test_torch_parity_curves.py --write

(one process a run, `--runs` picks them; 45 to 64 minutes of CPU for each
200-step hybrid reference, 40 seconds for the VAE's), and every file there
carries the sha256 of the JAX package's sources it was made from.

    python -m lunaris_orion_tpu_torch.tools.parity_curves --device cpu
    python -m lunaris_orion_tpu_torch.tools.parity_hybrid --device cpu \
        [--attn_window 256] [--modes deterministic]
    python -m lunaris_orion_tpu_torch.tools.window_dynamics --device cpu \
        --image_size 16 --batch 2 --steps 3
"""
