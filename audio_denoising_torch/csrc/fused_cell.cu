// One step of the matrixized GRUUNet cell as one CUDA kernel for Hopper
// (sm_90a).
//
// Replaces audio_denoising_tpu/ops/pallas/gruunet_cell.py::make_fused_cell's
// Pallas kernel (`kernel`, gruunet_cell.py:58), which PlanModel(fused=True)
// runs: the encoder matmul chain with ReLU, the reset-gate matmul on hx,
// the GRU gating hx' = n + z (hx - n), then the decoder matmuls with split
// skip matmuls. The state decay is left to the caller (PlanModel's
// decay_carry). It takes GRUUNet2, MOMO2 and MOMO3 plans in fp32; for a
// delta (MOMO3) plan (gruunet_cell.py:60-83) it loads the previous frame
// beside x, and level 0 runs over cat(x, prev) (plan_cell.cuh). The plain
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
// Design: the `plan_cell` walk of plan_cell.cuh, which the fused hop and
// the WebRTC hop's cell launch share, with its weights from the weight
// ring of weight_ring.cuh. One block of kThreads threads owns a tile of
// kTile = 2 streams, loads their rows of x and hx into shared memory
// (about 4.7 k floats per stream at gruunet2-good, 20 k at the five-level
// hidden-64 mel-128 plan), walks the cell's matmuls in order with every
// activation on chip on 15 consumer warps, and writes y and hx'. The
// last warp streams the plan's matrices into a ring of shared-memory
// stages in the slab order the wrapper computed, one bulk copy a slab
// multicast to a cluster of C = 2 blocks; the ring takes what the layout
// leaves of the block's 227 KB (3 stages of 64,944 B at gruunet2-good, 2
// of 35,808 B at the mel-128 plan, where the widest rows are 16 KB). The
// ragged last tile, and a block past the batch that rounds the grid up to
// whole clusters, compute on zero rows, take part in every barrier and
// store only the rows they own, so the batch is not padded.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, B = 256): the ring's
// copies, 56 GB/s into each SM (weight_ring.cuh); 58.4 us a step against
// 71 with the threads streaming the weights from L2.
//
// MOMO3-4d4ea0 (B = 256): 80,000 multiply-adds per stream, 41 MFLOP in
// all, 0.61 us against 67 TFLOP/s; its 0.33 MB of weights and 0.16 MB of
// x, prev, hx, y and hx' over 3.35 TB/s are 0.15 us. Its nine matrices
// (320 KB) stream through a ring of four stages as 14 slabs; the plan is
// so narrow that most of the 480 consumer threads idle in every matmul
// (the widest has 44 column quads), which is left as it is.

#include <cuda_runtime.h>

#include "weight_ring.cuh"

// Mirrored field by field by _Args in ops/kernels/fused_cell.py;
// adt_fused_cell_args_size lets the wrapper check the layouts agree.
struct AdtFusedCellArgs {
  const float* x;     // (B, n_feat) features
  const float* hx;    // (B, n_hidden) cell state
  const float* prev;  // (B, n_feat) the previous features (delta plans)
  float* y;         // (B, n_feat) residual prediction
  float* hx_out;    // (B, n_hidden) the new state, not decayed
  AdtPlan plan;
  AdtRing ring;     // the plan's matrices as a slab schedule
  int batch;
  int n_feat;
};

namespace {

__host__ __device__ inline int cell_layout_floats(const AdtPlan& p) {
  CellLayout l;
  int off = 0;
  make_cell_layout(p, &l, &off);
  return off;
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_cell_kernel(const __grid_constant__ AdtFusedCellArgs a) {
  extern __shared__ __align__(16) float smem[];
  CellLayout l;
  int off = 0;
  make_cell_layout(a.plan, &l, &off);
  const RingSmem ring = ring_smem(a.ring, smem, off);
  ring_init(a.ring, ring);
  const int b0 = blockIdx.x * kTile;
  const int rows = max(0, min(kTile, a.batch - b0));  // 0 past the batch
  const int F = a.n_feat, n = a.plan.n_hidden;

  // d[0] = x, or x | prev for a delta plan
  const int in = a.plan.delta ? 2 * F : F;
  for (int e = threadIdx.x; e < kTile * in; e += blockDim.x) {
    const int s = e / in, f = e % in;
    const float* src = f < F ? a.x : a.prev;
    smem[l.d[0] + s * l.ld_d[0] + f] =
        s < rows ? src[(size_t)(b0 + s) * F + f % F] : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * n; e += blockDim.x) {
    const int s = e / n, j = e % n;
    smem[l.hx + s * l.ld_n + j] =
        s < rows ? a.hx[(size_t)(b0 + s) * n + j] : 0.f;
  }
  cluster_sync();  // the ring's barriers ready in every block; x, hx loaded

  if (is_producer()) {
    if (threadIdx.x == kConsumers) ring_produce(a.ring, ring, 1);
  } else {
    const Lanes t = consumer_lanes();
    RingWeights w(a.ring, ring);
    const float* y = plan_cell(a.plan, l, smem, t, w);
    for (int e = t.id; e < rows * F; e += t.n) {
      const int s = e / F, f = e % F;
      a.y[(size_t)(b0 + s) * F + f] = y[s * l.ld_pp + f];
    }
    for (int e = t.id; e < rows * n; e += t.n) {
      const int s = e / n, j = e % n;
      a.hx_out[(size_t)(b0 + s) * n + j] = smem[l.hi + s * l.ld_n + j];
    }
  }
  __syncwarp();
  cluster_sync();  // no block leaves while the cluster copies into it
}

}  // namespace

extern "C" {

int adt_fused_cell_args_size() { return (int)sizeof(AdtFusedCellArgs); }

// Dynamic shared memory of one block's own layout (kTile streams' buffers,
// without the ring); -1 if the plan is not one the kernel takes.
long long adt_fused_cell_smem_bytes(const AdtFusedCellArgs* a) {
  if (!plan_ok(a->plan, a->n_feat)) return -1;
  return (long long)cell_layout_floats(a->plan) * (long long)sizeof(float);
}

// Launches one cell step on `stream` without synchronising; returns the
// launch's cudaError_t (0 on success).
int adt_fused_cell(const AdtFusedCellArgs* a, void* stream) {
  const long long layout = adt_fused_cell_smem_bytes(a);
  if (layout < 0 || !ring_ok(a->ring) || (a->plan.delta && !a->prev))
    return (int)cudaErrorInvalidValue;
  if (a->batch <= 0) return (int)cudaSuccess;
  return (int)launch_clusters(fused_cell_kernel, *a,
                              (a->batch + kTile - 1) / kTile, a->ring.cluster,
                              (size_t)(layout + ring_smem_bytes(a->ring)),
                              static_cast<cudaStream_t>(stream));
}

// Clusters of the launch for `blocks` blocks that the card holds at once
// (cudaOccupancyMaxActiveClusters); -1 on an error.
int adt_fused_cell_max_clusters(const AdtFusedCellArgs* a, int blocks) {
  const long long layout = adt_fused_cell_smem_bytes(a);
  if (layout < 0 || !ring_ok(a->ring)) return -1;
  return max_active_clusters(fused_cell_kernel, blocks, a->ring.cluster,
                             (size_t)(layout + ring_smem_bytes(a->ring)));
}

}  // extern "C"
