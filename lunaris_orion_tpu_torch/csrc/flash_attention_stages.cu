// K2 stage family -- the K2 forward cut after a named stage of the
// online-softmax chain, for Hopper (sm_90a). A measuring instrument: the time
// of stage n minus the time of stage n-1 is what that stage costs inside the
// forward kernel.
//
// Replaces tools/bench_attn_roofline.py `_stage_kernel` (launched by
// `_stage_fwd`).
//
// The kernels are the forward's own bodies (flash_attention_fwd.cuh, which
// states each level's semantics) with the stage level as a template
// parameter: bf16 on the tensor-core body, f32 on the CUDA-core body, both
// with key tiles of 64, without dropout, with whole key tiles, and with q
// taken as it comes (the caller scales it; scale = 1 here). Compiled for the
// teacher's head size d = 16 only: it is that shape the instrument reads.
// At "sum" the instance is the forward's own at dropout 0, so the two agree
// bit for bit.
//
// Nk must be a multiple of the key tile (a masked key has no meaning below
// "exp"); a ragged Nq is guarded.

#include "flash_attention_fwd.cuh"

namespace {

static_assert(kMmaBK == simt_block_k(16), "one key tile for both types");

template <int LVL>
int launch_stage(const LunarisK2FwdArgs& a, bool is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_mma<16, LVL, kDropOff, false>(a, s)
                 : launch_simt<float, 16, LVL, kDropOff, false>(a, s);
}

}  // namespace

// q: [BH, Nq, d] (already scaled); k, v: [BH, Nk, d]; f32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1), contiguous. bias: [H, Nk] f32. o: [BH, Nq, d] in the
// input type; lse: [BH, Nq] f32. d: 16. stage: 0..4 (dots, bias, maxsub,
// exp, sum). Nk a multiple of the key tile, 64.
// Returns the cudaError_t of the launch.
extern "C" int lunaris_flash_attention_stage(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int BH, int H, int Nq, int Nk, int d, int stage, int is_bf16,
    void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || BH > 65535 || d != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const LunarisK2FwdArgs a{q, k, v, static_cast<const float*>(bias), o,
                           static_cast<float*>(lse), BH, H, Nq, Nk, 1.f,
                           0, 0u, 1.f, 0u, 0, 0};
  auto s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return launch_stage<0>(a, is_bf16, s);
    case 1: return launch_stage<1>(a, is_bf16, s);
    case 2: return launch_stage<2>(a, is_bf16, s);
    case 3: return launch_stage<3>(a, is_bf16, s);
    case 4: return launch_stage<4>(a, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
