// Threaded-BVH traversal kernels for Hopper (sm_90a), one thread per ray.
// They replace the seven Pallas TPU BVH kernels of
// mitsuba_tpu/ops/pallas_bvh.py:
//   K3 lane_chunk       <- _lane_chunk               (resume, bounded)
//   K4 lane_packed      <- bvh_traverse_lane_packed  (from the root)
//   K5 lane_hbm         <- bvh_traverse_lane_hbm     (from the root, big trees)
//   K6 lane_chunk_hbm   <- _lane_chunk_hbm           (resume, big trees)
//   K7 treelet_rounds   <- bvh_traverse_treelets     (two-level, _treelet_rounds)
//   K8 fat_walk         <- bvh_traverse_packed       (leaves of <= 4)
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
// H100 there is no VMEM/HBM split, so K5 and K6 compute what K3 computes
// (K5 from the root) on the trees above 2.3M nodes that the scene sends them,
// with their own schedule (below).
//
// The octant tables. The canonical walk always enters the left child first,
// so a closest-hit ray enters boxes behind its eventual hit until it finds
// it, and a launch lasts as long as its slowest lanes (503 visits where the
// mean is 10 on the bunny's sorted bounce rays, 553 where it is 40.5 on the
// large tier's rays), each visit a dependent L2 or HBM round trip. So a
// closest-hit lane of K3, K5, K6, K7 and K9 walks one of eight copies of the
// tree (pack_nodes_octants), the one of its direction's octant (bit k set
// where d[k] >= 0), in which each internal node's nearer child comes first:
// the closest hit comes early, and the slab test's exit, clamped by the best
// t, culls the boxes behind it. K5 starts at row 0 of that table, K3, K6 and
// K9 resume at a row of it, K7 walks a treelet's range of it; K9 reads the
// same tables laid out as wide pages (pack_pages_w_octants). The per-visit
// arithmetic is unchanged. K4 walks the canonical table: on the camera rays
// it serves (the render's presorted bounce 0, coherent, whose canonical walk
// is nearly near-first already: the octant walk saves 8% of their visits)
// the octant walk ran 10% slower than the canonical one and the canonical
// walk in an instantiation of its own 4% faster than K4's shared one (while
// on the sorted bounce rays the octant walk took K4 from 0.130 to 0.061 ms;
// NVIDIA H100 80GB HBM3, 700 W; scripts/torch_lane_sweep.py).
// The canonical walk keeps the first of several hits at equal t, which is
// the one with the lowest canonical leaf row; the octant walk keeps the same
// one by the tie rule: a hit at tt == best replaces the best only where the
// lane is armed (K3, K5, K6, K9: it has a best; K7: a best from the treelet
// it is walking, since the JAX rounds keep a best from an earlier treelet)
// and the leaf's canonical row (c.w of the octant rows; on K9's wide pages,
// which have no word for it, leaf_row[tid], exact on a leaf-1 tree) is below
// leaf_row[idx]; the map is read only on such a tie. Any-hit lanes (shadow
// rays) walk the canonical table, each kernel in an instantiation of its own
// but K3's and K7's: the JAX kernels return the first hit in its order, and
// order does not help occlusion.
//
// K5 and K6 (the large tier: 2.53M nodes, 262,144 rays, a 122 MB canonical
// table and 978 MB of octant tables against the 50 MB L2). Their
// closest-hit lanes walk the octant tables too: 24% fewer visits and a 29%
// shorter longest chain, for 59% more distinct rows read (2.0M, 98 MB
// against 1.3M, 62 MB). Any-hit launches run their own instantiation, so
// that an any-hit lane holds no octant table or tie rule in registers; both
// run one thread per ray in blocks of 128, 12 resident per SM
// (HBM_MIN_BLOCKS). Latency bounds them, so resident warps count. The
// persistent design of Aila & Laine ("Understanding the Efficiency of Ray
// Traversal on GPUs", HPG 2009), one wave of blocks whose lanes take the
// next ray index from a counter when their ray is done, ran 28-52% slower
// on an NVIDIA H100 80GB HBM3 at 700 W: the per-visit warp votes and extra
// registers cost more than the idle lanes they reclaim, and a refilled lane
// no longer walks beside the rays sorted next to its own.
//
// K7 (treelets). The tree is cut into K <= 128 treelets, subtrees whose rows
// are the range [root, skip) (accel/build.py:treelet_roots), in every table
// a contiguous range. _treelet_rounds (pallas_bvh.py:453-482) picks, each
// round, the nearest pending root box the ray enters before its best hit
// (lowest index on a tie) and walks that treelet. A box's entry does not
// depend on the best, and its exit is min(exit, best) exactly, so that order
// is the ascending (entry, index) order of the boxes the ray enters against
// its t_max, cut at the first entry beyond the best. K7 therefore tests all K
// root boxes once per ray, in a loop that is the same for every lane of a
// warp (the (K, 24) table of lo, hi, root, skip and each octant's (root,
// end), 12 KB, sits in shared memory and is read by broadcast), keeps the
// TREELET_LIST nearest entered boxes as a sorted list in registers, and walks
// them in order until an entry lies beyond the best (an any-hit lane: until
// it hits). A ray that enters more boxes finishes with the old pending-mask
// rounds over the entered treelets it has not walked, so the order stays the
// JAX one whatever the list's size. Dead lanes start retired.
// K8 (leaves of up to four triangles; cuda_bvh.pack_fat_tables). The JAX
// kernel's fat rows (fourteen float4s a node: a 32-byte head, then four
// triangle slots) are split into three tables: 32-byte heads (lo.xyz | skip,
// hi.xyz | word; a leaf's word is the int32 first << 3 | count of its slots,
// an internal node's 0), one table of 48-byte slots (p0.xyz | id, e1.xyz,
// e2.xyz) in canonical leaf order, and eight near-first octant copies of the
// heads that point into the same slots. A visit reads one head; every box is
// tested, leaves too; an entered leaf's slots load together and are tested in
// slot order (pallas_bvh.py:140-191). Closest-hit lanes without a range walk
// their octant's heads with the tie rule by slot index (fat_leaf); any-hit
// lanes and lanes bounded to a per-ray [start, end) of canonical rows (a
// subtree is such a range) walk the canonical heads, and retire when the
// pointer leaves the range. On the bunny's sorted bounce rays the octant walk
// runs 35% faster than the same kernel on the canonical heads (0.0651-0.0664
// against 0.1004-0.1015 ms), so closest hits take it; on the coherent camera
// rays it runs 14% slower (0.0388-0.0397 against 0.0337-0.0342), as K4's did.
// The leaf's loads sent together beat loads slot by slot (46 registers, 10
// blocks per SM) by 14-18% at 80-85 registers and 5-6 blocks (NVIDIA H100
// 80GB HBM3, 700 W; scripts/torch_fat_sweep.py).
// K9 (wide pages, pack_pages_w; pages of WIDE_PAGE = 256 nodes, the JAX
// default, fixed at compile time). K3's chunk, reading component c of node n
// from row (n / 256) * 22 + 2 c + (n % 256) / 128, lane n % 128: neighbouring
// threads on neighbouring nodes load neighbouring words, where K3 loads
// 48-byte rows. A visit computes the node's word once and loads eight words
// (lo, hi, skip, tri id) or, at a leaf, eleven, each 1 KB from the next. It
// answers whether that structure-of-arrays layout pays on the card.
// Dead lanes (t_max <= t_min) start retired in every kernel: no triangle can
// pass t_min < t < t_max, so the outputs are the TPU kernels' (a miss).
//
// What bounds them on an H100. A visit reads 32 bytes of an internal node or
// 48 of a leaf (K8: 32 plus 48 per slot tested; K9: 32 or 44) and does a
// slab test (25 fp32 operations) or a triangle test (46, one a division); K7
// adds K slab tests per ray (and one per pending treelet per overflow
// round). A ray reads 32 bytes (K4, K5, K7, K8) or 48 (K3, K6, K9) and writes
// 17 or 20. Counting each node a launch reads once, bytes bound them: a few
// microseconds for the bunny's 262,144 rays. The kernels take several times
// that, because each load depends on the one before (the next node needs
// this one), repeat visits are served from L1/L2, and a launch lasts as
// long as its slowest lanes (hundreds of visits where the mean is 5-40).
// The octant tables shorten K3's and K7's longest chains (503 to 203 visits
// on the bunny's bounce rays); of their 8 x 15.2 MB a launch there reads
// 114,000 distinct rows, 5.5 MB, well inside the 50 MB L2. On the large
// tier K5's and K6's closest-hit lanes read twice the L2 (98 MB of rows),
// and the octant walk gains little there: 2-3% over the canonical walk at
// the registers the compiler takes, and K5 2.5% more from the launch
// bounds (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_hbm_sweep.py).
// Shared-memory treelets, a short stack or a wide BVH are later work.
//
// Compile with -fmad=false: the plain PyTorch versions round every operation,
// and contraction into FMAs would flip edge hits between the two.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;  // rays per block
// K3's and K7's __launch_bounds__ minimum of resident blocks per SM. Left
// free, K3 takes 48 registers (10 blocks of 128 per SM) and K7 64 (8 blocks),
// so 262,144 rays take 1.6 and 1.9 waves; every higher minimum spills and
// runs slower (scripts/torch_occupancy_sweep.py, which builds with others).
#ifndef K3_MIN_BLOCKS
#define K3_MIN_BLOCKS 1
#endif
#ifndef K7_MIN_BLOCKS
#define K7_MIN_BLOCKS 1
#endif
// K5's and K6's __launch_bounds__ minimum of resident blocks per SM: 12
// holds them to 40 registers (a few bytes spill), where the compiler left
// free takes 44-51 (9-10 blocks); 16 spills and runs slower
// (scripts/torch_hbm_sweep.py builds with others)
#ifndef HBM_MIN_BLOCKS
#define HBM_MIN_BLOCKS 12
#endif
// K4's and K9's __launch_bounds__ minimum of resident blocks per SM
// (scripts/torch_lane_sweep.py builds with others)
#ifndef K4_MIN_BLOCKS
#define K4_MIN_BLOCKS 1
#endif
#ifndef K9_MIN_BLOCKS
#define K9_MIN_BLOCKS 1
#endif
// K8's __launch_bounds__ minimum of resident blocks per SM. Left free, its
// instantiations take 80-85 registers (5-6 blocks of 128 per SM); 8, 10 and
// 12 blocks spill the leaf's twelve float4s and run slower
// (scripts/torch_fat_sweep.py builds with others)
#ifndef K8_MIN_BLOCKS
#define K8_MIN_BLOCKS 1
#endif
// K8's triangle slots per leaf (cuda_bvh.FAT_LEAF_SIZE)
constexpr int FAT_SLOTS = 4;
// K7's list of entered treelets per ray (cuda_bvh.TREELET_LIST)
constexpr int TREELET_LIST = 8;
// K9's nodes per wide page (cuda_bvh.WIDE_PAGE) and component rows per page
constexpr int WIDE_PAGE = 256;
constexpr int PCOMP = 11;

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

// A table layout: row(n) is where node n lies, computed once per visit; ab
// and c load its three float4s; canon is a leaf's canonical row for the tie
// rule; plus(k) is the table k elements further (an octant's table).
// The node-major table: three float4s per node.
struct NodeRows {
  const float4* __restrict__ nodes;
  using Row = const float4*;
  __device__ __forceinline__ Row row(int n) const { return nodes + 3 * n; }
  __device__ __forceinline__ static void ab(Row r, float4& a, float4& b) {
    a = __ldg(r);
    b = __ldg(r + 1);
  }
  __device__ __forceinline__ static float4 c(Row r) { return __ldg(r + 2); }
  // the octant rows carry it in c.w
  __device__ __forceinline__ static int canon(const float4& c,
                                              const int* __restrict__, int) {
    return static_cast<int>(c.w);
  }
  __device__ __forceinline__ NodeRows plus(size_t k) const {
    return NodeRows{nodes + k};
  }
};

// K9's wide pages of WIDE_PAGE nodes: component k of node n is the word
// STRIDE * k after row(n).
struct WidePages {
  const float* __restrict__ pages;
  using Row = const float*;
  static constexpr int VPP = WIDE_PAGE / 128;
  static constexpr int STRIDE = VPP * 128;
  __device__ __forceinline__ Row row(int n) const {
    const int p = n / WIDE_PAGE, r = n % WIDE_PAGE;
    return pages + (p * PCOMP * VPP + (r >> 7)) * 128 + (r & 127);
  }
  __device__ __forceinline__ static void ab(Row r, float4& a, float4& b) {
    a = make_float4(__ldg(r), __ldg(r + STRIDE), __ldg(r + 2 * STRIDE),
                    __ldg(r + 9 * STRIDE));
    b = make_float4(__ldg(r + 3 * STRIDE), __ldg(r + 4 * STRIDE),
                    __ldg(r + 5 * STRIDE), __ldg(r + 10 * STRIDE));
  }
  __device__ __forceinline__ static float4 c(Row r) {
    return make_float4(__ldg(r + 6 * STRIDE), __ldg(r + 7 * STRIDE),
                       __ldg(r + 8 * STRIDE), 0.0f);
  }
  // no word for it: the map, exact on a leaf-1 tree
  __device__ __forceinline__ static int canon(const float4&,
                                              const int* __restrict__ leaf_row,
                                              int tid) {
    return __ldg(leaf_row + tid);
  }
  __device__ __forceinline__ WidePages plus(size_t k) const {
    return WidePages{pages + k};
  }
};

// Moeller-Trumbore on p0, e1, e2 (the TPU kernels' form and order): true and
// (tt, uu, vv) when the ray hits the triangle beyond t_min, whatever the best.
__device__ __forceinline__ bool tri_geo(float ox, float oy, float oz, float dx,
                                        float dy, float dz, float p0x,
                                        float p0y, float p0z, float e1x,
                                        float e1y, float e1z, float e2x,
                                        float e2y, float e2z, float t_min,
                                        float& tt, float& uu, float& vv) {
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
  return ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > t_min;
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

// The tie rule of the octant walks: leaf_row maps a triangle id to its
// canonical leaf row (null: no tie rule, the canonical walks); armed says the
// lane's best was found in this walk (K3) or treelet (K7).
struct Tie {
  const int* __restrict__ leaf_row;
  bool armed;
};

// The direction's octant: bit k set where d[k] >= 0 (ray_sort_keys' code).
__device__ __forceinline__ int octant_of(float dx, float dy, float dz) {
  return (dx >= 0.0f ? 1 : 0) | (dy >= 0.0f ? 2 : 0) | (dz >= 0.0f ? 4 : 0);
}

// Walk one lane until its pointer passes the last node or reaches end (the
// lane then retires: node = n_nodes), its any-hit lane finds a hit, or
// max_steps visits are spent (0: no budget). With tie.leaf_row, a hit at
// t == best replaces an armed best from a leaf of a lower canonical row.
template <class Table>
__device__ void walk(const Table& table, Tie& tie, int n_nodes, int end,
                     float ox, float oy, float oz, float dx, float dy,
                     float dz, float t_min, bool any_hit, int max_steps,
                     Lane& s) {
  const float inx = safe_inv(dx), iny = safe_inv(dy), inz = safe_inv(dz);
  int steps = 0;
  while (s.node < n_nodes && (max_steps == 0 || steps < max_steps)) {
    const typename Table::Row row = table.row(s.node);
    float4 a, b;
    Table::ab(row, a, b);
    const int skip = static_cast<int>(a.w);
    const int tid = static_cast<int>(b.w);
    int next = skip;
    if (tid >= 0) {
      // leaf: p0 = a.xyz, e1 = b.xyz, e2 = c.xyz
      const float4 c = Table::c(row);
      float tt, uu, vv;
      const bool geo = tri_geo(ox, oy, oz, dx, dy, dz, a.x, a.y, a.z, b.x,
                               b.y, b.z, c.x, c.y, c.z, t_min, tt, uu, vv);
      bool take = geo && tt < s.t;
      if (tie.leaf_row && geo && tt == s.t && tie.armed)
        take = Table::canon(c, tie.leaf_row, tid) <
               __ldg(tie.leaf_row + s.idx);
      if (take) {
        s.t = tt;
        s.idx = tid;
        s.u = uu;
        s.v = vv;
        tie.armed = true;
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

// K4 and K5: from the root (row 0 of every table); a dead lane (t_max <=
// t_min) starts retired. With octant (K5), closest-hit lanes walk their
// octant's table with the tie rule, unarmed; K4's walk the canonical table.
// Any-hit and closest-hit launches are separate instantiations, so that an
// any-hit lane carries no octant table or tie rule in its registers.
template <bool any_hit, bool octant>
__device__ __forceinline__ void root_lane(
    const float4* __restrict__ nodes, const float4* __restrict__ oct,
    const int* __restrict__ leaf_row, int n_nodes,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max, int R,
    bool* __restrict__ hit, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ u_out,
    float* __restrict__ v_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float tmin = t_min[r], tmax = t_max[r];
  const float rdx = d[3 * r], rdy = d[3 * r + 1], rdz = d[3 * r + 2];
  Lane s{tmax > tmin ? 0 : n_nodes, tmax, -1, 0.0f, 0.0f};
  const float4* table = nodes;
  Tie tie{nullptr, false};
  if (!any_hit && octant) {
    table = oct + 3 * static_cast<size_t>(n_nodes) * octant_of(rdx, rdy, rdz);
    tie.leaf_row = leaf_row;
  }
  walk(NodeRows{table}, tie, n_nodes, n_nodes, o[3 * r], o[3 * r + 1],
       o[3 * r + 2], rdx, rdy, rdz, tmin, any_hit, 0, s);
  const bool h = s.idx >= 0;
  hit[r] = h;
  t_out[r] = h ? s.t : CUDART_INF_F;
  idx_out[r] = s.idx;
  u_out[r] = s.u;
  v_out[r] = s.v;
}

// One __global__ per TPU kernel, so each has its own name in a profile.
// K4: the canonical walk, an instantiation per query kind.
template <bool any_hit>
__global__ void __launch_bounds__(THREADS, K4_MIN_BLOCKS) lane_packed_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max, int R,
    bool* __restrict__ hit, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ u_out,
    float* __restrict__ v_out) {
  root_lane<any_hit, false>(nodes, nullptr, nullptr, n_nodes, o, d, t_min,
                            t_max, R, hit, t_out, idx_out, u_out, v_out);
}

// K3, K6 and K9: resume from (node, t, idx, u, v) for at most max_steps
// visits; rays as one array per component, the layout the resort loop
// sorts. Any-hit lanes walk canon; closest-hit lanes their octant's table
// (oct.plus(stride * octant)) with the tie rule, armed where the lane has a
// best (i_in >= 0).
template <class Table>
__device__ __forceinline__ void octant_chunk_lane(
    const Table& canon, const Table& oct, size_t stride,
    const int* __restrict__ leaf_row, int n_nodes,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_min, const int* __restrict__ node_in,
    const float* __restrict__ t_in, const int* __restrict__ i_in,
    const float* __restrict__ u_in, const float* __restrict__ v_in, int R,
    bool any_hit, int max_steps,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ node_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Lane s{node_in[r], t_in[r], i_in[r], u_in[r], v_in[r]};
  const float rdx = dx[r], rdy = dy[r], rdz = dz[r];
  Table table = canon;
  Tie tie{nullptr, s.idx >= 0};
  if (!any_hit) {
    table = oct.plus(stride * octant_of(rdx, rdy, rdz));
    tie.leaf_row = leaf_row;
  }
  walk(table, tie, n_nodes, n_nodes, ox[r], oy[r], oz[r], rdx, rdy, rdz,
       t_min[r], any_hit, max_steps, s);
  t_out[r] = s.t;
  idx_out[r] = s.idx;
  u_out[r] = s.u;
  v_out[r] = s.v;
  node_out[r] = s.node;
}

// The arguments K3, K6 and K9 share after their tables.
#define CHUNK_PARAMS                                                        \
  const int* __restrict__ leaf_row, int n_nodes,                            \
      const float* __restrict__ ox, const float* __restrict__ oy,           \
      const float* __restrict__ oz, const float* __restrict__ dx,           \
      const float* __restrict__ dy, const float* __restrict__ dz,           \
      const float* __restrict__ t_min, const int* __restrict__ node_in,     \
      const float* __restrict__ t_in, const int* __restrict__ i_in,         \
      const float* __restrict__ u_in, const float* __restrict__ v_in, int R
#define CHUNK_OUTS                                                          \
  float *__restrict__ t_out, int *__restrict__ idx_out,                     \
      float *__restrict__ u_out, float *__restrict__ v_out,                 \
      int *__restrict__ node_out
#define CHUNK_ARGS                                                          \
  leaf_row, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in, t_in, i_in,    \
      u_in, v_in, R
#define CHUNK_OUT_ARGS t_out, idx_out, u_out, v_out, node_out

// K3
__global__ void __launch_bounds__(THREADS, K3_MIN_BLOCKS) lane_chunk_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ oct,
    CHUNK_PARAMS, bool any_hit, int max_steps, CHUNK_OUTS) {
  octant_chunk_lane(NodeRows{nodes}, NodeRows{oct}, 3 * size_t(n_nodes),
                    CHUNK_ARGS, any_hit, max_steps, CHUNK_OUT_ARGS);
}

// K5: K4's lane on the octant tables, under launch bounds of its own.
template <bool any_hit>
__global__ void __launch_bounds__(THREADS, HBM_MIN_BLOCKS) lane_hbm_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ oct,
    const int* __restrict__ leaf_row, int n_nodes,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max, int R,
    bool* __restrict__ hit, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ u_out,
    float* __restrict__ v_out) {
  root_lane<any_hit, true>(nodes, oct, leaf_row, n_nodes, o, d, t_min,
                           t_max, R, hit, t_out, idx_out, u_out, v_out);
}

// K6: K3's lane under K5's launch bounds, an instantiation per query kind.
template <bool any_hit>
__global__ void __launch_bounds__(THREADS, HBM_MIN_BLOCKS)
    lane_chunk_hbm_kernel(const float4* __restrict__ nodes,
                          const float4* __restrict__ oct, CHUNK_PARAMS,
                          int max_steps, CHUNK_OUTS) {
  octant_chunk_lane(NodeRows{nodes}, NodeRows{oct}, 3 * size_t(n_nodes),
                    CHUNK_ARGS, any_hit, max_steps, CHUNK_OUT_ARGS);
}

// K9: K3's lane over wide pages (closest hit: each octant's table laid out
// as wide pages, stride words apart), an instantiation per query kind.
template <bool any_hit>
__global__ void __launch_bounds__(THREADS, K9_MIN_BLOCKS) lane_chunk_w_kernel(
    const float* __restrict__ pages, const float* __restrict__ oct,
    size_t stride, CHUNK_PARAMS, int max_steps, CHUNK_OUTS) {
  octant_chunk_lane(WidePages{pages}, WidePages{oct}, stride, CHUNK_ARGS,
                    any_hit, max_steps, CHUNK_OUT_ARGS);
}

constexpr int MAX_TREELETS = 128;
// lo.xyz, hi.xyz, root, skip, then (root, end) in each octant's table
constexpr int TREELET_COLS = 24;
constexpr int PEND_WORDS = MAX_TREELETS / 32;

// Clear bit k of a four-word mask held in registers (no dynamic index, so
// the words stay in registers).
__device__ __forceinline__ void clear_bit(unsigned (&mask)[PEND_WORDS],
                                          int k) {
#pragma unroll
  for (int w = 0; w < PEND_WORDS; ++w)
    if (w == (k >> 5)) mask[w] &= ~(1u << (k & 31));
}

__global__ void __launch_bounds__(THREADS, K7_MIN_BLOCKS)
    treelet_rounds_kernel(const float4* __restrict__ nodes,
                          const float4* __restrict__ oct,
                          const int* __restrict__ leaf_row, int n_nodes,
                          const float* __restrict__ tab, int K,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ t_min,
                          const float* __restrict__ t_max, int R,
                          bool any_hit, bool* hit, float* t_out, int* idx_out,
                          float* u_out, float* v_out) {
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
  // any-hit lanes walk [root, skip) of the canonical table, closest-hit
  // lanes their octant's (root, end) with the tie rule
  const float4* table = nodes;
  int col = 6;
  Tie tie{nullptr, false};
  if (!any_hit) {
    const int oc = octant_of(dx, dy, dz);
    table = oct + 3 * static_cast<size_t>(n_nodes) * oc;
    col = 8 + 2 * oc;
    tie.leaf_row = leaf_row;
  }
  const NodeRows rows{table};

  // one pass over the root boxes against t_max: the entered ones in a mask,
  // the TREELET_LIST nearest by (entry, index) in a sorted register list
  unsigned ent[PEND_WORDS] = {0u, 0u, 0u, 0u};
  float lt[TREELET_LIST];
  int lk[TREELET_LIST];
#pragma unroll
  for (int i = 0; i < TREELET_LIST; ++i) {
    lt[i] = CUDART_INF_F;
    lk[i] = 0;
  }
  int nl = 0;
  if (tmax > tmin) {
#pragma unroll
    for (int w = 0; w < PEND_WORDS; ++w) {
      for (int j = 0; j < 32; ++j) {
        const int k = 32 * w + j;
        if (k >= K) break;
        const float* e = s_tab + TREELET_COLS * k;
        float tn;
        if (!box_hit(e[0], e[1], e[2], e[3], e[4], e[5], ox, oy, oz, inx, iny,
                     inz, tmin, tmax, tn))
          continue;
        ent[w] |= 1u << j;
        if (!(tn < CUDART_INF_F)) continue;
        nl = min(nl + 1, TREELET_LIST);
        // insert in (entry, index) order: k is larger than every index in
        // the list, so an equal entry goes behind
        float ct = tn;
        int ck = k;
#pragma unroll
        for (int i = 0; i < TREELET_LIST; ++i) {
          if (ct < lt[i]) {
            const float ft = lt[i];
            const int fk = lk[i];
            lt[i] = ct;
            lk[i] = ck;
            ct = ft;
            ck = fk;
          }
        }
      }
    }
  }
  // walk the list in order; an entry beyond the best ends the lane, since
  // every later one is beyond it too
  bool done = false;
  for (int i = 0; i < nl && !done; ++i) {
    if (lt[0] > s.t) {
      done = true;
      break;
    }
    const int k = lk[0];
    clear_bit(ent, k);
#pragma unroll
    for (int j = 0; j + 1 < TREELET_LIST; ++j) {
      lt[j] = lt[j + 1];
      lk[j] = lk[j + 1];
    }
    lt[TREELET_LIST - 1] = CUDART_INF_F;
    s.node = static_cast<int>(s_tab[TREELET_COLS * k + col]);
    tie.armed = false;
    walk(rows, tie, n_nodes, static_cast<int>(s_tab[TREELET_COLS * k + col + 1]),
         ox, oy, oz, dx, dy, dz, tmin, any_hit, 0, s);
    done = any_hit && s.idx >= 0;
  }
  // overflow: _treelet_rounds' rounds over the entered treelets not yet
  // walked; each round the nearest one whose box the ray enters before its
  // best hit, set bits in index order, so a tie keeps the lowest index
  while (!done) {
    float best_e = CUDART_INF_F;
    int sel = -1;
#pragma unroll
    for (int w = 0; w < PEND_WORDS; ++w) {
      unsigned bits = ent[w];
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
    clear_bit(ent, sel);
    s.node = static_cast<int>(s_tab[TREELET_COLS * sel + col]);
    tie.armed = false;
    walk(rows, tie, n_nodes,
         static_cast<int>(s_tab[TREELET_COLS * sel + col + 1]), ox, oy, oz,
         dx, dy, dz, tmin, any_hit, 0, s);
    done = any_hit && s.idx >= 0;
  }
  const bool h = s.idx >= 0;
  hit[r] = h;
  t_out[r] = h ? s.t : CUDART_INF_F;
  idx_out[r] = s.idx;
  u_out[r] = s.u;
  v_out[r] = s.v;
}

// K8's leaf: the slots tris[first, first + count) of a leaf whose box the
// lane entered, loaded together (each predicated on k < count), then tested
// in slot order. A hit replaces the best where tt < best or, with the tie
// rule (closest hit), where tt == best from a lower slot index: the slots are
// in canonical (leaf row, slot) order, so that is the hit the canonical walk
// meets first. bs is -1 until the lane has a best, and no slot is below -1.
template <bool tie>
__device__ __forceinline__ void fat_leaf(const float4* __restrict__ tris,
                                         int word, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float tmin, float& bt,
                                         int& bs, float& bu, float& bv) {
  const int first = word >> 3, cnt = word & 7;
  float4 p[FAT_SLOTS], e1[FAT_SLOTS], e2[FAT_SLOTS];
#pragma unroll
  for (int k = 0; k < FAT_SLOTS; ++k) {
    if (k < cnt) {
      const float4* slot = tris + 3 * (first + k);
      p[k] = __ldg(slot);        // p0.xyz | id
      e1[k] = __ldg(slot + 1);
      e2[k] = __ldg(slot + 2);
    }
  }
#pragma unroll
  for (int k = 0; k < FAT_SLOTS; ++k) {
    if (k < cnt) {
      float tt, uu, vv;
      if (tri_geo(ox, oy, oz, dx, dy, dz, p[k].x, p[k].y, p[k].z, e1[k].x,
                  e1[k].y, e1[k].z, e2[k].x, e2[k].y, e2[k].z, tmin, tt, uu,
                  vv) &&
          (tt < bt || (tie && tt == bt && first + k < bs))) {
        bt = tt;
        bs = first + k;
        bu = uu;
        bv = vv;
      }
    }
  }
}

// K8 over its split tables, an instantiation per query kind and per bounded
// or not: closest-hit lanes without a range walk their octant's near-first
// heads from row 0, the others the canonical heads from start (or the root).
// A visit tests the head's box against (t_min, best); an entered internal
// node descends to node + 1, an entered leaf tests its slots; the lane
// retires when its pointer reaches min(end, n_nodes) or, any-hit, on a hit.
template <bool any_hit, bool bounded>
__global__ void __launch_bounds__(THREADS, K8_MIN_BLOCKS) fat_walk_kernel(
    const float4* __restrict__ heads, const float4* __restrict__ oct,
    const float4* __restrict__ tris, int n_nodes,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const int* __restrict__ start, const int* __restrict__ end, int R,
    bool* __restrict__ hit, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ u_out,
    float* __restrict__ v_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float tmin = t_min[r], tmax = t_max[r];
  const float inx = safe_inv(dx), iny = safe_inv(dy), inz = safe_inv(dz);
  int node = 0, lim = n_nodes;
  if (bounded) {
    node = start[r];
    lim = min(end[r], n_nodes);
  }
  // a lane outside the table's rows is dead, not an out-of-bounds read
  if (!(tmax > tmin && node >= 0 && node < lim)) node = lim;
  const float4* table = heads;
  if (!any_hit && !bounded)
    table = oct + 2 * static_cast<size_t>(n_nodes) * octant_of(dx, dy, dz);
  float bt = tmax, bu = 0.0f, bv = 0.0f;
  int bs = -1;
  while (node < lim) {
    const float4 a = __ldg(table + 2 * node);      // lo.xyz | skip
    const float4 b = __ldg(table + 2 * node + 1);  // hi.xyz | word
    const int word = __float_as_int(b.w);
    int next = static_cast<int>(a.w);
    float tnear;
    if (box_hit(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz, inx, iny, inz, tmin,
                bt, tnear)) {
      if (word == 0)
        next = node + 1;
      else
        fat_leaf<!any_hit>(tris, word, ox, oy, oz, dx, dy, dz, tmin, bt, bs,
                           bu, bv);
    }
    node = next;
    if (any_hit && bs >= 0) break;
  }
  const bool h = bs >= 0;
  hit[r] = h;
  t_out[r] = h ? bt : CUDART_INF_F;
  idx_out[r] = h ? static_cast<int>(__ldg(tris + 3 * bs).w) : -1;
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
  auto kernel = any_hit ? lane_packed_kernel<true> : lane_packed_kernel<false>;
  kernel<<<blocks_for(R), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, o, d, t_min, t_max, R,
      hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

// K3: oct is the (8, n_nodes, 12) float32 octant tables, 16-byte aligned,
// and leaf_row the (T,) int32 map; both may be null for an any-hit call.
extern "C" int bvh_lane_chunk(const float* nodes, const float* oct,
                              const int* leaf_row, int n_nodes,
                              const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const float* t_min, const int* node_in,
                              const float* t_in, const int* i_in,
                              const float* u_in, const float* v_in, int R,
                              int any_hit, int max_steps, float* t, int* idx,
                              float* u, float* v, int* node, void* stream) {
  if (!any_hit && (!oct || !leaf_row))
    return static_cast<int>(cudaErrorInvalidValue);
  lane_chunk_kernel<<<blocks_for(R), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(oct), leaf_row, n_nodes, ox, oy, oz, dx,
      dy, dz, t_min, node_in, t_in, i_in, u_in, v_in, R, any_hit != 0,
      max_steps, t, idx, u, v, node);
  return static_cast<int>(cudaGetLastError());
}

// K5 and K6: oct and leaf_row as for K3.
extern "C" int bvh_lane_hbm(const float* nodes, const float* oct,
                            const int* leaf_row, int n_nodes, const float* o,
                            const float* d, const float* t_min,
                            const float* t_max, int R, int any_hit, bool* hit,
                            float* t, int* idx, float* u, float* v,
                            void* stream) {
  if (!any_hit && (!oct || !leaf_row))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = any_hit ? lane_hbm_kernel<true> : lane_hbm_kernel<false>;
  kernel<<<blocks_for(R), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(oct), leaf_row, n_nodes, o, d, t_min,
      t_max, R, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_lane_chunk_hbm(const float* nodes, const float* oct,
                                  const int* leaf_row, int n_nodes,
                                  const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* t_min, const int* node_in,
                                  const float* t_in, const int* i_in,
                                  const float* u_in, const float* v_in, int R,
                                  int any_hit, int max_steps, float* t,
                                  int* idx, float* u, float* v, int* node,
                                  void* stream) {
  if (!any_hit && (!oct || !leaf_row))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = any_hit ? lane_chunk_hbm_kernel<true>
                        : lane_chunk_hbm_kernel<false>;
  kernel<<<blocks_for(R), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(oct), leaf_row, n_nodes, ox, oy, oz, dx,
      dy, dz, t_min, node_in, t_in, i_in, u_in, v_in, R, max_steps, t, idx, u,
      v, node);
  return static_cast<int>(cudaGetLastError());
}

// K9: pages is the (n_pages * 22, 128) float32 table of pack_pages_w at
// page == WIDE_PAGE (256 nodes), n_pages >= ceil(n_nodes / 256), and oct the
// (8, ceil(n_nodes / 256) * 22, 128) float32 tables of pack_pages_w_octants;
// oct and leaf_row may be null for an any-hit call.
extern "C" int bvh_lane_chunk_w(const float* pages, const float* oct,
                                const int* leaf_row, int page, int n_nodes,
                                const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const float* t_min, const int* node_in,
                                const float* t_in, const int* i_in,
                                const float* u_in, const float* v_in, int R,
                                int any_hit, int max_steps, float* t,
                                int* idx, float* u, float* v, int* node,
                                void* stream) {
  if (page != WIDE_PAGE || (!any_hit && (!oct || !leaf_row)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t stride = static_cast<size_t>((n_nodes + WIDE_PAGE - 1) /
                                            WIDE_PAGE) * PCOMP * WIDE_PAGE;
  auto kernel = any_hit ? lane_chunk_w_kernel<true>
                        : lane_chunk_w_kernel<false>;
  kernel<<<blocks_for(R), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pages, oct, stride, leaf_row, n_nodes, ox, oy, oz, dx, dy, dz, t_min,
      node_in, t_in, i_in, u_in, v_in, R, max_steps, t, idx, u, v, node);
  return static_cast<int>(cudaGetLastError());
}

// K7: tab is the (K, 24) float32 treelet table, 1 <= K <= 128; oct and
// leaf_row as for K3.
extern "C" int bvh_treelet_rounds(const float* nodes, const float* oct,
                                  const int* leaf_row, int n_nodes,
                                  const float* tab, int K, const float* o,
                                  const float* d, const float* t_min,
                                  const float* t_max, int R, int any_hit,
                                  bool* hit, float* t, int* idx, float* u,
                                  float* v, void* stream) {
  if (K < 1 || K > MAX_TREELETS || (!any_hit && (!oct || !leaf_row)))
    return static_cast<int>(cudaErrorInvalidValue);
  treelet_rounds_kernel<<<blocks_for(R), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(oct), leaf_row, n_nodes, tab, K, o, d,
      t_min, t_max, R, any_hit != 0, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

// K8: heads is the (n_nodes, 8) float32 canonical head table, oct the (8,
// n_nodes, 8) octant heads (may be null for an any-hit or bounded call) and
// tris the (S, 12) triangle slots, all 16-byte aligned; start and end are
// (R,) int32 node ranges, or both null for [0, n_nodes).
extern "C" int bvh_fat_packed(const float* heads, const float* oct,
                              const float* tris, int n_nodes, const float* o,
                              const float* d, const float* t_min,
                              const float* t_max, const int* start,
                              const int* end, int R, int any_hit, bool* hit,
                              float* t, int* idx, float* u, float* v,
                              void* stream) {
  const bool bounded = start != nullptr;
  if (bounded != (end != nullptr) || (!any_hit && !bounded && !oct))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = any_hit ? (bounded ? fat_walk_kernel<true, true>
                                   : fat_walk_kernel<true, false>)
                        : (bounded ? fat_walk_kernel<false, true>
                                   : fat_walk_kernel<false, false>);
  kernel<<<blocks_for(R), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(heads),
      reinterpret_cast<const float4*>(oct),
      reinterpret_cast<const float4*>(tris), n_nodes, o, d, t_min, t_max,
      start, end, R, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and resident blocks of THREADS per SM of K3 (which
// 0), K7 (1), K6 (2), K5 (3), K4 (6) and K9 (8) closest hit, K6 (4), K5 (5),
// K4 (7) and K9 (9) any-hit, and K8 closest (10), any-hit (11), bounded
// closest (12) and bounded any-hit (13), for the occupancy the build's
// -Xptxas -v implies.
extern "C" int bvh_kernel_occupancy(int which, int* regs, int* blocks) {
  const void* fns[] = {
      reinterpret_cast<const void*>(lane_chunk_kernel),
      reinterpret_cast<const void*>(treelet_rounds_kernel),
      reinterpret_cast<const void*>(lane_chunk_hbm_kernel<false>),
      reinterpret_cast<const void*>(lane_hbm_kernel<false>),
      reinterpret_cast<const void*>(lane_chunk_hbm_kernel<true>),
      reinterpret_cast<const void*>(lane_hbm_kernel<true>),
      reinterpret_cast<const void*>(lane_packed_kernel<false>),
      reinterpret_cast<const void*>(lane_packed_kernel<true>),
      reinterpret_cast<const void*>(lane_chunk_w_kernel<false>),
      reinterpret_cast<const void*>(lane_chunk_w_kernel<true>),
      reinterpret_cast<const void*>(fat_walk_kernel<false, false>),
      reinterpret_cast<const void*>(fat_walk_kernel<true, false>),
      reinterpret_cast<const void*>(fat_walk_kernel<false, true>),
      reinterpret_cast<const void*>(fat_walk_kernel<true, true>)};
  constexpr int n_fns = sizeof(fns) / sizeof(fns[0]);
  if (which < 0 || which >= n_fns)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = fns[which];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS, 0));
}
