// One step of the matrixized GRUUNet cell as one CUDA kernel for Hopper
// (sm_90a).
//
// Replaces audio_denoising_tpu/ops/pallas/gruunet_cell.py::make_fused_cell's
// Pallas kernel (`kernel`, gruunet_cell.py:58), which PlanModel(fused=True)
// runs: the encoder matmul chain with ReLU, the reset-gate matmul on hx,
// the GRU gating hx' = n + z (hx - n), then the decoder matmuls with split
// skip matmuls. The state decay is left to the caller (PlanModel's
// decay_carry). This slice covers non-delta plans in fp32. The plain
// PyTorch version of the same function is FusedCell.reference in
// audio_denoising_torch/ops/kernels/fused_cell.py.
//
// What bounds it on an H100 (gruunet2-good, B = 256 streams): one step is
// 710,192 multiply-adds per stream, 363.6 MFLOP in all, 5.4 us against
// 67 TFLOP/s of fp32 FMA; its bytes (2.85 MB of plan weights, x, hx, y and
// hx' of 0.27 MB) over 3.35 TB/s are 0.9 us: the step is bound by fp32
// operations. Parity with the reference needs fp32, so the kernel uses
// FMA, not TF32 tensor cores.
//
// Design: the `plan_cell` routine of plan_cell.cuh, which the fused hop and
// the WebRTC hop's cell launch share, launched on its own. One block of
// kThreads threads owns a tile of kTile streams, loads their rows of x and
// hx into shared memory (about 4.7 k floats per stream at gruunet2-good,
// 20 k at the five-level hidden-64 mel-128 plan, both well inside a
// block's 227 KB), walks the cell's matmuls in order with every activation
// on chip, and writes y and hx'. The weights stay in global memory and are
// served from the 50 MB L2, each block reading each weight once per step;
// the small-GEMM routine spends them as float4 loads that each feed
// 4 kTile FMAs and splits the narrow stages over k (plan_cell.cuh says
// how). The ragged last tile computes on zero rows and stores only the
// rows it owns, so the batch is not padded. The tile is the shared
// header's (2 streams), which measured best for the fused hop on an H100:
// at B = 256 the step is 128 blocks, one per SM.

#include <cuda_runtime.h>

#include "plan_cell.cuh"

// Mirrored field by field by _Args in ops/kernels/fused_cell.py;
// adt_fused_cell_args_size lets the wrapper check the layouts agree.
struct AdtFusedCellArgs {
  const float* x;   // (B, n_feat) features
  const float* hx;  // (B, n_hidden) cell state
  float* y;         // (B, n_feat) residual prediction
  float* hx_out;    // (B, n_hidden) the new state, not decayed
  AdtPlan plan;
  int batch;
  int n_feat;
};

namespace {

__global__ void __launch_bounds__(kThreads, 1)
    fused_cell_kernel(const __grid_constant__ AdtFusedCellArgs a) {
  extern __shared__ __align__(16) float smem[];
  CellLayout l;
  int off = 0;
  make_cell_layout(a.plan, &l, &off);
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.batch - b0);
  const int F = a.n_feat, n = a.plan.n_hidden;

  for (int e = threadIdx.x; e < kTile * F; e += blockDim.x) {
    const int s = e / F, f = e % F;
    smem[l.d[0] + s * l.ld_d[0] + f] =
        s < rows ? a.x[(size_t)(b0 + s) * F + f] : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    smem[l.hx + s * l.ld_n + j] =
        s < rows ? a.hx[(size_t)(b0 + s) * n + j] : 0.f;
  }
  __syncthreads();

  const float* y = plan_cell(a.plan, l, smem);

  for (int e = threadIdx.x; e < rows * F; e += blockDim.x) {
    const int s = e / F, f = e % F;
    a.y[(size_t)(b0 + s) * F + f] = y[s * l.ld_pp + f];
  }
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    a.hx_out[(size_t)(b0 + s) * n + j] = smem[l.hi + s * l.ld_n + j];
  }
}

}  // namespace

extern "C" {

int adt_fused_cell_args_size() { return (int)sizeof(AdtFusedCellArgs); }

// Dynamic shared memory one block of kTile streams needs; -1 if the plan
// is not one the kernel takes.
long long adt_fused_cell_smem_bytes(const AdtFusedCellArgs* a) {
  if (!plan_ok(a->plan, a->n_feat)) return -1;
  CellLayout l;
  int off = 0;
  make_cell_layout(a->plan, &l, &off);
  return (long long)off * (long long)sizeof(float);
}

// Launches one cell step on `stream` without synchronising; returns the
// launch's cudaError_t (0 on success).
int adt_fused_cell(const AdtFusedCellArgs* a, void* stream) {
  const long long smem = adt_fused_cell_smem_bytes(a);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fused_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a->batch + kTile - 1) / kTile);
  fused_cell_kernel<<<grid, kThreads, (size_t)smem,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
