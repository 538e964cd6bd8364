// Threaded-BVH traversal kernels for Hopper (sm_90a), one thread per ray.
// They replace the seven Pallas TPU BVH kernels of
// mitsuba_tpu/ops/pallas_bvh.py:
//   K3 lane_chunk       <- _lane_chunk               (resume, bounded)
//   K4 lane_packed      <- bvh_traverse_lane_packed  (from the root)
//   K5 lane_hbm         <- bvh_traverse_lane_hbm     (from the root, big trees)
//   K6 lane_chunk_hbm   <- _lane_chunk_hbm           (resume, big trees)
//   K7 treelet_rounds   <- bvh_traverse_treelets     (two-level, _treelet_rounds)
//   K8 fat_packed       <- bvh_traverse_packed       (fat rows, leaves of <= 4)
//   K9 lane_chunk_w     <- _lane_chunk_w             (K3 over wide pages)
// All compute what the TPU kernels compute: per ray the closest hit
// (t, triangle id, u, v) within (t_min, t_max), or with any_hit the first hit
// found, over a BVH whose nodes are in depth-first order with skip (miss)
// links. Triton does not fit a data-dependent pointer walk, so all are CUDA
// C++.
//
// Design. The TPU kernels cut the node stream into pages of 128 nodes, keep
// each node component as one 128-lane row, and let a block of 1024 lanes
// gather from the page its lanes share, because Mosaic has no per-lane gather
// (pallas_bvh.py:878-893). Hopper gathers per thread, so each thread walks its
// own skip-link pointer: node = (box hit && !leaf) ? node + 1 : skip[node].
// A node is three float4s (48 bytes, node-major, one 16-byte load each):
//   lo.xyz | skip        (a leaf stores its triangle's p0 here)
//   hi.xyz | tri id      (-1 for an internal node; a leaf stores e1)
//   e2.xyz | 0           (zero on internal nodes)
// skip and tri id are exact floats below 2^24, as in the TPU page table. The
// per-node arithmetic is _sweep_lane's (pallas_bvh.py:999-1036), in its order:
// slab test against t_min and the best t so far, Moeller-Trumbore with
// 1/where(|det| > 1e-12, det, 1), a hit only for t_min < t < best. A lane's
// node sequence depends on nothing but its own state, so the result does not
// depend on the schedule: how many visits a launch makes, or how the caller
// re-sorts lanes between launches.
//
// K3 and K6 resume from per-lane state (node, t, idx, u, v) and stop after
// max_steps node visits (0: to the end); the TPU's budget counted outer page
// iterations of a 1024-lane block instead, which has no meaning here. On the
// H100 there is no VMEM/HBM split, so K5 and K6 differ from K4 and K3 only by
// the size of the tree they are given (the scene sends trees above 2.3M nodes
// to K5).
//
// K7 (treelets). The tree is cut into K <= 128 treelets, subtrees whose rows
// are the range [root, skip) (accel/build.py:treelet_roots). Each round a lane
// tests the root boxes of its pending treelets in index order with
// _treelet_rounds' arithmetic (pallas_bvh.py:453-482: entry clamped by t_min,
// exit by the best t so far, a strict < so ties go to the lowest index),
// clears the nearest one's bit and walks its rows with the shared walk, which
// retires the lane when its pointer reaches the treelet's end. The (K, 8)
// table (lo, hi, root, skip) sits in shared memory, 4 KB; the pending set is
// four 32-bit masks in registers. An any-hit lane stops at its first hit.
// K8 (fat rows). Each node is fourteen float4s: lo.xyz | skip, hi.xyz | count,
// then per triangle slot p0.xyz | id, e1.xyz | 0, e2.xyz | 0. Every node's box
// is tested, leaves too; a hit box of a leaf tests its count triangles in slot
// order (pallas_bvh.py:140-191). Optional per-ray [start, end) bounds retire a
// lane whose pointer leaves the range (a subtree is such a range).
// K9 (wide pages, pack_pages_w). K3's walk, reading component c of node n
// from row (n / page) * 11 * vpp + c * vpp + (n % page) / 128, lane n % 128:
// neighbouring threads on neighbouring nodes load neighbouring words, where
// K3 loads 48-byte rows. It answers whether that structure-of-arrays layout
// pays on the card.
// Dead lanes (t_max <= t_min) start retired in every kernel: no triangle can
// pass t_min < t < t_max, so the outputs are the TPU kernels' (a miss).
//
// What bounds them on an H100. A visit reads 32 bytes of an internal node or
// 48 of a leaf (K8: 32 plus 48 per tested triangle; K9: 32 or 44) and does a
// slab test (25 fp32 operations) or a triangle test (46, one a division); K7
// adds a slab test per pending treelet per round. A ray reads 32 bytes (K4,
// K5, K7, K8) or 48 (K3, K6, K9) and writes 17 or 20. Counting each node a
// launch reads once, bytes bound them: a few microseconds for the bunny's
// 262,144 rays. The kernels take several times that, because each load
// depends on the one before (the next node needs this one), repeat visits are
// served from L1/L2, and a launch lasts as long as its slowest lanes
// (hundreds of visits where the mean is 5-40). Shared-memory treelets, a
// short stack or a wide BVH are later work.
//
// Compile with -fmad=false: the plain PyTorch versions round every operation,
// and contraction into FMAs would flip edge hits between the two.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;  // rays per block

struct Lane {
  int node;
  float t;
  int idx;
  float u;
  float v;
};

// _safe_inv_v: 1 / x, with |x| < 1e-12 replaced by +-1e-12 (sign of x < 0)
__device__ __forceinline__ float safe_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-12f ? (x < 0.0f ? -1e-12f : 1e-12f) : x);
}

// The node-major table: three float4s per node.
struct NodeRows {
  const float4* __restrict__ nodes;
  __device__ __forceinline__ void ab(int n, float4& a, float4& b) const {
    a = __ldg(nodes + 3 * n);
    b = __ldg(nodes + 3 * n + 1);
  }
  __device__ __forceinline__ float4 c(int n) const {
    return __ldg(nodes + 3 * n + 2);
  }
};

// K9's wide pages: the same three float4s, gathered from component rows.
struct WidePages {
  const float* __restrict__ pages;
  int page, vpp;
  __device__ __forceinline__ float at(int n, int comp) const {
    const int p = n / page, r = n - p * page;
    return __ldg(pages + ((p * 11 + comp) * vpp + (r >> 7)) * 128 + (r & 127));
  }
  __device__ __forceinline__ void ab(int n, float4& a, float4& b) const {
    a = make_float4(at(n, 0), at(n, 1), at(n, 2), at(n, 9));
    b = make_float4(at(n, 3), at(n, 4), at(n, 5), at(n, 10));
  }
  __device__ __forceinline__ float4 c(int n) const {
    return make_float4(at(n, 6), at(n, 7), at(n, 8), 0.0f);
  }
};

// Moeller-Trumbore on p0, e1, e2 (the TPU kernels' form and order): true and
// (tt, uu, vv) when the ray hits within (t_min, best).
__device__ __forceinline__ bool tri_hit(float ox, float oy, float oz, float dx,
                                        float dy, float dz, float p0x,
                                        float p0y, float p0z, float e1x,
                                        float e1y, float e1z, float e2x,
                                        float e2y, float e2z, float t_min,
                                        float best, float& tt, float& uu,
                                        float& vv) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = fabsf(det) > 1e-12f;
  const float invd = 1.0f / (ok ? det : 1.0f);
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  uu = (tvx * pvx + tvy * pvy + tvz * pvz) * invd;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  vv = (dx * qx + dy * qy + dz * qz) * invd;
  tt = (e2x * qx + e2y * qy + e2z * qz) * invd;
  return ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > t_min &&
         tt < best;
}

// Slab test of box (lo, hi) against (t_min, best): _sweep_lane's order.
__device__ __forceinline__ bool box_hit(float lox, float loy, float loz,
                                        float hix, float hiy, float hiz,
                                        float ox, float oy, float oz,
                                        float inx, float iny, float inz,
                                        float t_min, float best, float& tnear) {
  const float t0x = (lox - ox) * inx, t1x = (hix - ox) * inx;
  const float t0y = (loy - oy) * iny, t1y = (hiy - oy) * iny;
  const float t0z = (loz - oz) * inz, t1z = (hiz - oz) * inz;
  tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                fmaxf(fminf(t0z, t1z), t_min));
  const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), best));
  return tnear <= tfar;
}

// Walk one lane until its pointer passes the last node or reaches end (the
// lane then retires: node = n_nodes), its any-hit lane finds a hit, or
// max_steps visits are spent (0: no budget).
template <class Table>
__device__ void walk(const Table& table, int n_nodes, int end, float ox,
                     float oy, float oz, float dx, float dy, float dz,
                     float t_min, bool any_hit, int max_steps, Lane& s) {
  const float inx = safe_inv(dx), iny = safe_inv(dy), inz = safe_inv(dz);
  int steps = 0;
  while (s.node < n_nodes && (max_steps == 0 || steps < max_steps)) {
    float4 a, b;
    table.ab(s.node, a, b);
    const int skip = static_cast<int>(a.w);
    const int tid = static_cast<int>(b.w);
    int next = skip;
    if (tid >= 0) {
      // leaf: p0 = a.xyz, e1 = b.xyz, e2 = c.xyz
      const float4 c = table.c(s.node);
      float tt, uu, vv;
      if (tri_hit(ox, oy, oz, dx, dy, dz, a.x, a.y, a.z, b.x, b.y, b.z, c.x,
                  c.y, c.z, t_min, s.t, tt, uu, vv)) {
        s.t = tt;
        s.idx = tid;
        s.u = uu;
        s.v = vv;
      }
    } else {
      // internal node: slab test on lo = a.xyz, hi = b.xyz
      float tnear;
      if (box_hit(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz, inx, iny, inz,
                  t_min, s.t, tnear))
        next = s.node + 1;
    }
    s.node = next >= end ? n_nodes : next;
    ++steps;
    if (any_hit && s.idx >= 0) s.node = n_nodes;
  }
}

// K4 and K5: from the root. A dead lane (t_max <= t_min) starts retired.
__device__ void root_lane(const float4* __restrict__ nodes, int n_nodes,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ t_min,
                          const float* __restrict__ t_max, int R, bool any_hit,
                          bool* __restrict__ hit, float* __restrict__ t_out,
                          int* __restrict__ idx_out, float* __restrict__ u_out,
                          float* __restrict__ v_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float tmin = t_min[r], tmax = t_max[r];
  Lane s{tmax > tmin ? 0 : n_nodes, tmax, -1, 0.0f, 0.0f};
  walk(NodeRows{nodes}, n_nodes, n_nodes, o[3 * r], o[3 * r + 1],
       o[3 * r + 2], d[3 * r], d[3 * r + 1], d[3 * r + 2], tmin, any_hit, 0,
       s);
  const bool h = s.idx >= 0;
  hit[r] = h;
  t_out[r] = h ? s.t : CUDART_INF_F;
  idx_out[r] = s.idx;
  u_out[r] = s.u;
  v_out[r] = s.v;
}

// K3, K6 and K9: resume from (node, t, idx, u, v); rays as one array per
// component, the layout the resort loop sorts.
template <class Table>
__device__ void chunk_lane(
    const Table& table, int n_nodes, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ t_min,
    const int* __restrict__ node_in, const float* __restrict__ t_in,
    const int* __restrict__ i_in, const float* __restrict__ u_in,
    const float* __restrict__ v_in, int R, bool any_hit, int max_steps,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ node_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Lane s{node_in[r], t_in[r], i_in[r], u_in[r], v_in[r]};
  walk(table, n_nodes, n_nodes, ox[r], oy[r], oz[r], dx[r], dy[r], dz[r],
       t_min[r], any_hit, max_steps, s);
  t_out[r] = s.t;
  idx_out[r] = s.idx;
  u_out[r] = s.u;
  v_out[r] = s.v;
  node_out[r] = s.node;
}

// One __global__ per TPU kernel, so each has its own name in a profile.
__global__ void lane_packed_kernel(const float4* __restrict__ nodes,
                                   int n_nodes, const float* __restrict__ o,
                                   const float* __restrict__ d,
                                   const float* __restrict__ t_min,
                                   const float* __restrict__ t_max, int R,
                                   bool any_hit, bool* hit, float* t, int* idx,
                                   float* u, float* v) {
  root_lane(nodes, n_nodes, o, d, t_min, t_max, R, any_hit, hit, t, idx, u, v);
}

__global__ void lane_hbm_kernel(const float4* __restrict__ nodes, int n_nodes,
                                const float* __restrict__ o,
                                const float* __restrict__ d,
                                const float* __restrict__ t_min,
                                const float* __restrict__ t_max, int R,
                                bool any_hit, bool* hit, float* t, int* idx,
                                float* u, float* v) {
  root_lane(nodes, n_nodes, o, d, t_min, t_max, R, any_hit, hit, t, idx, u, v);
}

__global__ void lane_chunk_kernel(
    const float4* __restrict__ nodes, int n_nodes, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* t_min, const int* node_in,
    const float* t_in, const int* i_in, const float* u_in, const float* v_in,
    int R, bool any_hit, int max_steps, float* t, int* idx, float* u,
    float* v, int* node) {
  chunk_lane(NodeRows{nodes}, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in,
             t_in, i_in, u_in, v_in, R, any_hit, max_steps, t, idx, u, v,
             node);
}

__global__ void lane_chunk_hbm_kernel(
    const float4* __restrict__ nodes, int n_nodes, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* t_min, const int* node_in,
    const float* t_in, const int* i_in, const float* u_in, const float* v_in,
    int R, bool any_hit, int max_steps, float* t, int* idx, float* u,
    float* v, int* node) {
  chunk_lane(NodeRows{nodes}, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in,
             t_in, i_in, u_in, v_in, R, any_hit, max_steps, t, idx, u, v,
             node);
}

__global__ void lane_chunk_w_kernel(
    const float* __restrict__ pages, int page, int n_nodes, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* t_min, const int* node_in,
    const float* t_in, const int* i_in, const float* u_in, const float* v_in,
    int R, bool any_hit, int max_steps, float* t, int* idx, float* u,
    float* v, int* node) {
  chunk_lane(WidePages{pages, page, page / 128}, n_nodes, ox, oy, oz, dx, dy,
             dz, t_min, node_in, t_in, i_in, u_in, v_in, R, any_hit,
             max_steps, t, idx, u, v, node);
}

constexpr int MAX_TREELETS = 128;
constexpr int TREELET_COLS = 8;  // lo.xyz, hi.xyz, root, skip
constexpr int PEND_WORDS = MAX_TREELETS / 32;

__global__ void treelet_rounds_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ tab, int K, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_min,
    const float* __restrict__ t_max, int R, bool any_hit, bool* hit,
    float* t_out, int* idx_out, float* u_out, float* v_out) {
  __shared__ float s_tab[MAX_TREELETS * TREELET_COLS];
  for (int i = threadIdx.x; i < K * TREELET_COLS; i += blockDim.x)
    s_tab[i] = tab[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float tmin = t_min[r], tmax = t_max[r];
  const float inx = safe_inv(dx), iny = safe_inv(dy), inz = safe_inv(dz);
  Lane s{n_nodes, tmax, -1, 0.0f, 0.0f};
  unsigned pend[PEND_WORDS];
#pragma unroll
  for (int w = 0; w < PEND_WORDS; ++w) {
    const int left = K - 32 * w;
    pend[w] = !(tmax > tmin) || left <= 0 ? 0u
              : left >= 32                ? 0xFFFFFFFFu
                                          : (1u << left) - 1u;
  }
  const NodeRows rows{nodes};
  while (true) {
    // the nearest pending treelet whose box the ray enters before its best
    // hit; set bits in index order, so a tie keeps the lowest index
    float best_e = CUDART_INF_F;
    int sel = -1;
#pragma unroll
    for (int w = 0; w < PEND_WORDS; ++w) {
      unsigned bits = pend[w];
      while (bits) {
        const int k = 32 * w + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float* e = s_tab + TREELET_COLS * k;
        float tn;
        if (box_hit(e[0], e[1], e[2], e[3], e[4], e[5], ox, oy, oz, inx, iny,
                    inz, tmin, s.t, tn) &&
            tn < best_e) {
          best_e = tn;
          sel = k;
        }
      }
    }
    if (sel < 0) break;
#pragma unroll
    for (int w = 0; w < PEND_WORDS; ++w)
      if (w == (sel >> 5)) pend[w] &= ~(1u << (sel & 31));
    s.node = static_cast<int>(s_tab[TREELET_COLS * sel + 6]);
    walk(rows, n_nodes, static_cast<int>(s_tab[TREELET_COLS * sel + 7]), ox,
         oy, oz, dx, dy, dz, tmin, any_hit, 0, s);
    if (any_hit && s.idx >= 0) break;
  }
  const bool h = s.idx >= 0;
  hit[r] = h;
  t_out[r] = h ? s.t : CUDART_INF_F;
  idx_out[r] = s.idx;
  u_out[r] = s.u;
  v_out[r] = s.v;
}

constexpr int FAT_F4 = 14;   // float4s per fat row: 2 + 3 per slot
constexpr int FAT_SLOTS = 4;

__global__ void fat_packed_kernel(
    const float4* __restrict__ rows, int n_nodes, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_min,
    const float* __restrict__ t_max, const int* __restrict__ start,
    const int* __restrict__ end, int R, bool any_hit, bool* hit,
    float* t_out, int* idx_out, float* u_out, float* v_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float tmin = t_min[r], tmax = t_max[r];
  const float inx = safe_inv(dx), iny = safe_inv(dy), inz = safe_inv(dz);
  const int first = start ? start[r] : 0;
  const int stop = end ? end[r] : n_nodes;
  // a lane outside the table's rows is dead, not an out-of-bounds read
  int node = tmax > tmin && first >= 0 && first < stop ? first : n_nodes;
  float bt = tmax, bu = 0.0f, bv = 0.0f;
  int bi = -1;
  while (node < n_nodes) {
    const float4* row = rows + FAT_F4 * node;
    const float4 a = __ldg(row);      // lo.xyz | skip
    const float4 b = __ldg(row + 1);  // hi.xyz | count
    const int cnt = static_cast<int>(b.w);
    float tnear;
    const bool hit_box = box_hit(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz,
                                 inx, iny, inz, tmin, bt, tnear);
    if (hit_box) {
      for (int k = 0; k < cnt && k < FAT_SLOTS; ++k) {
        const float4 p = __ldg(row + 2 + 3 * k);   // p0.xyz | id
        const float4 e1 = __ldg(row + 3 + 3 * k);
        const float4 e2 = __ldg(row + 4 + 3 * k);
        float tt, uu, vv;
        if (tri_hit(ox, oy, oz, dx, dy, dz, p.x, p.y, p.z, e1.x, e1.y, e1.z,
                    e2.x, e2.y, e2.z, tmin, bt, tt, uu, vv)) {
          bt = tt;
          bi = static_cast<int>(p.w);
          bu = uu;
          bv = vv;
        }
      }
    }
    const int next = hit_box && cnt == 0 ? node + 1 : static_cast<int>(a.w);
    node = next >= stop || (any_hit && bi >= 0) ? n_nodes : next;
  }
  const bool h = bi >= 0;
  hit[r] = h;
  t_out[r] = h ? bt : CUDART_INF_F;
  idx_out[r] = bi;
  u_out[r] = bu;
  v_out[r] = bv;
}

int blocks_for(int R) { return (R + THREADS - 1) / THREADS; }

}  // namespace

// C entry points, bound with ctypes. Each launches on the given stream and
// returns cudaGetLastError(), so a refused launch is seen at once. nodes is
// the (n_nodes, 12) float32 table, 16-byte aligned.
extern "C" int bvh_lane_packed(const float* nodes, int n_nodes, const float* o,
                               const float* d, const float* t_min,
                               const float* t_max, int R, int any_hit,
                               bool* hit, float* t, int* idx, float* u,
                               float* v, void* stream) {
  lane_packed_kernel<<<blocks_for(R), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, o, d, t_min, t_max, R,
      any_hit != 0, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_lane_hbm(const float* nodes, int n_nodes, const float* o,
                            const float* d, const float* t_min,
                            const float* t_max, int R, int any_hit, bool* hit,
                            float* t, int* idx, float* u, float* v,
                            void* stream) {
  lane_hbm_kernel<<<blocks_for(R), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, o, d, t_min, t_max, R,
      any_hit != 0, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_lane_chunk(const float* nodes, int n_nodes, const float* ox,
                              const float* oy, const float* oz,
                              const float* dx, const float* dy,
                              const float* dz, const float* t_min,
                              const int* node_in, const float* t_in,
                              const int* i_in, const float* u_in,
                              const float* v_in, int R, int any_hit,
                              int max_steps, float* t, int* idx, float* u,
                              float* v, int* node, void* stream) {
  lane_chunk_kernel<<<blocks_for(R), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, ox, oy, oz, dx, dy, dz,
      t_min, node_in, t_in, i_in, u_in, v_in, R, any_hit != 0, max_steps, t,
      idx, u, v, node);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_lane_chunk_hbm(const float* nodes, int n_nodes,
                                  const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* t_min, const int* node_in,
                                  const float* t_in, const int* i_in,
                                  const float* u_in, const float* v_in, int R,
                                  int any_hit, int max_steps, float* t,
                                  int* idx, float* u, float* v, int* node,
                                  void* stream) {
  lane_chunk_hbm_kernel<<<blocks_for(R), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, ox, oy, oz, dx, dy, dz,
      t_min, node_in, t_in, i_in, u_in, v_in, R, any_hit != 0, max_steps, t,
      idx, u, v, node);
  return static_cast<int>(cudaGetLastError());
}

// K9: pages is the (n_pages * 11 * page / 128, 128) float32 table of
// pack_pages_w; page a positive multiple of 128.
extern "C" int bvh_lane_chunk_w(const float* pages, int page, int n_nodes,
                                const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const float* t_min, const int* node_in,
                                const float* t_in, const int* i_in,
                                const float* u_in, const float* v_in, int R,
                                int any_hit, int max_steps, float* t,
                                int* idx, float* u, float* v, int* node,
                                void* stream) {
  if (page <= 0 || page % 128) return static_cast<int>(cudaErrorInvalidValue);
  lane_chunk_w_kernel<<<blocks_for(R), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pages, page, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in, t_in,
      i_in, u_in, v_in, R, any_hit != 0, max_steps, t, idx, u, v, node);
  return static_cast<int>(cudaGetLastError());
}

// K7: tab is the (K, 8) float32 treelet table, 1 <= K <= 128.
extern "C" int bvh_treelet_rounds(const float* nodes, int n_nodes,
                                  const float* tab, int K, const float* o,
                                  const float* d, const float* t_min,
                                  const float* t_max, int R, int any_hit,
                                  bool* hit, float* t, int* idx, float* u,
                                  float* v, void* stream) {
  if (K < 1 || K > MAX_TREELETS)
    return static_cast<int>(cudaErrorInvalidValue);
  treelet_rounds_kernel<<<blocks_for(R), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, tab, K, o, d, t_min,
      t_max, R, any_hit != 0, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

// K8: rows is the (n_nodes, 56) float32 fat table, 16-byte aligned; start
// and end are (R,) int32 node ranges, or both null for [0, n_nodes).
extern "C" int bvh_fat_packed(const float* rows, int n_nodes, const float* o,
                              const float* d, const float* t_min,
                              const float* t_max, const int* start,
                              const int* end, int R, int any_hit, bool* hit,
                              float* t, int* idx, float* u, float* v,
                              void* stream) {
  fat_packed_kernel<<<blocks_for(R), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows), n_nodes, o, d, t_min, t_max,
      start, end, R, any_hit != 0, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}
