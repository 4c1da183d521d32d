// Serial f32 reference of the gather-GEMM function of kernels 1, 2
// (weighted) and 4 (dx), which kernel 6 computes from pair tables, compiled
// into the emulated kernel library by tests/test_torch_kernels_emulated.py:
//
//   out[i, co] = epi( chain over k < K in order, skipping idx[k, i] ==
//                     sentinel, of c < Cin in order:
//                     acc = fmaf(x[idx[k, i], c], w[k, c, co], acc) )
//
// from acc = 0, then the kernels' own epilogue (gather_gemm.cuh). This is
// the order the f32 ring body promises: every output one fmaf chain over
// the offsets in order, then the Cin chunks in order, then the channels in
// order, so its output equals this one bitwise.
#include <cmath>

#include "gather_gemm.cuh"

extern "C" int serial_gather_gemm_f32(const float* x, const float* w,
                                      const int* idx, const uint8_t* valid,
                                      const float* scale, const float* shift,
                                      const float* residual, float* out,
                                      int K, int n_out, int sentinel, int cin,
                                      int cout, int relu) {
  for (int i = 0; i < n_out; ++i)
    for (int co = 0; co < cout; ++co) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const int src = idx[(size_t)k * n_out + i];
        if (src == sentinel) continue;
        for (int c = 0; c < cin; ++c)
          acc = std::fmaf(x[(size_t)src * cin + c],
                          w[((size_t)k * cin + c) * cout + co], acc);
      }
      us3d::epilogue_store(acc, valid[i] ? 1.f : 0.f, (size_t)i * cout + co,
                           co, scale, shift, residual, out, relu);
    }
  return 0;
}
