// K2 fused backward on the windowed fold -- one instance of
// `flash_bwd_window_tf32` (flash_attention_window_tf32.cuh): f32 at head
// size 16, with dropout.

#include "flash_attention_window_tf32.cuh"

int lunaris_k2_bwd_window_tf32_d16_drop(const LunarisK2WindowArgs& a, cudaStream_t s) {
  return launch_bwd_window_tf32<16, kDropOn>(a, s);
}
