// K2 forward on the windowed fold -- one instance of `flash_fwd_window`
// (flash_attention_window.cuh): bf16 at head size 32, without dropout.

#include "flash_attention_window.cuh"

int lunaris_k2_fwd_window_d32(const LunarisK2WindowArgs& a, cudaStream_t s) {
  return launch_fwd_window<32, kDropOff>(a, s);
}
