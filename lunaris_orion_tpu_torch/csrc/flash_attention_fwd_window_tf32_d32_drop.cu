// K2 forward on the windowed fold -- one instance of `flash_fwd_window_tf32`
// (flash_attention_window_tf32.cuh): f32 at head size 32, with dropout.

#include "flash_attention_window_tf32.cuh"

int lunaris_k2_fwd_window_tf32_d32_drop(const LunarisK2WindowArgs& a, cudaStream_t s) {
  return launch_fwd_window_tf32<32, kDropOn>(a, s);
}
