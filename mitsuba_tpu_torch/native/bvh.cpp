// Native binned-SAH BVH builder: the port's own copy of
// mitsuba_tpu/native/bvh.cpp (host code is copied, never shared).
//
// It produces the threaded (skip-link) array layout of accel/build.py --
// same SAH binning, same DFS emission -- at C++ speed for large meshes,
// exposed to Python through a plain C ABI (ctypes). The output does not
// depend on the thread count. The one change from the JAX package's copy:
// the thread count is the hardware's; no environment variable is read.
//
// Built at first use by mitsuba_tpu_torch/native/__init__.py with the JAX
// package's flags (g++ -O3 -march=native -std=c++17 -fPIC -shared -pthread),
// so that on one host both packages build the same tree.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>
#include <functional>

namespace {

constexpr int N_BINS = 16;

struct BuildNode {
    float lo[3], hi[3];
    int32_t left = -1;     // index of left child (right = emitted after left subtree)
    int32_t first = -1;    // leaf: offset into prim_order
    int32_t count = 0;
};

struct Builder {
    const float* prim_lo;
    const float* prim_hi;
    std::vector<float> centroid;   // T*3
    std::vector<BuildNode> nodes;
    std::vector<int32_t> order;
    int leaf_size;

    void node_bounds(const std::vector<int32_t>& idx, BuildNode& n) const {
        for (int c = 0; c < 3; ++c) {
            n.lo[c] = std::numeric_limits<float>::infinity();
            n.hi[c] = -std::numeric_limits<float>::infinity();
        }
        for (int32_t i : idx) {
            for (int c = 0; c < 3; ++c) {
                n.lo[c] = std::min(n.lo[c], prim_lo[3 * i + c]);
                n.hi[c] = std::max(n.hi[c], prim_hi[3 * i + c]);
            }
        }
    }

    // SAH binned split of idx into (left_idx, right_idx); median fallback.
    void partition(const std::vector<int32_t>& idx,
                   std::vector<int32_t>& left_idx,
                   std::vector<int32_t>& right_idx) const {
        const size_t cnt = idx.size();
        float clo[3], chi[3];
        for (int c = 0; c < 3; ++c) {
            clo[c] = std::numeric_limits<float>::infinity();
            chi[c] = -std::numeric_limits<float>::infinity();
        }
        for (int32_t i : idx) {
            for (int c = 0; c < 3; ++c) {
                float v = centroid[3 * i + c];
                clo[c] = std::min(clo[c], v);
                chi[c] = std::max(chi[c], v);
            }
        }

        float best_cost = std::numeric_limits<float>::infinity();
        int best_axis = -1, best_bin = -1;

        for (int axis = 0; axis < 3; ++axis) {
            float extent = chi[axis] - clo[axis];
            if (extent < 1e-12f) continue;
            float inv = N_BINS / extent;
            int bin_cnt[N_BINS] = {0};
            float blo[N_BINS][3], bhi[N_BINS][3];
            for (int b = 0; b < N_BINS; ++b)
                for (int c = 0; c < 3; ++c) {
                    blo[b][c] = std::numeric_limits<float>::infinity();
                    bhi[b][c] = -std::numeric_limits<float>::infinity();
                }
            for (int32_t i : idx) {
                int b = std::min(
                    (int)((centroid[3 * i + axis] - clo[axis]) * inv), N_BINS - 1);
                bin_cnt[b]++;
                for (int c = 0; c < 3; ++c) {
                    blo[b][c] = std::min(blo[b][c], prim_lo[3 * i + c]);
                    bhi[b][c] = std::max(bhi[b][c], prim_hi[3 * i + c]);
                }
            }
            // sweep
            float llo[3], lhi[3];
            float area_l[N_BINS];
            int cnt_l[N_BINS];
            for (int c = 0; c < 3; ++c) {
                llo[c] = std::numeric_limits<float>::infinity();
                lhi[c] = -std::numeric_limits<float>::infinity();
            }
            int acc = 0;
            for (int b = 0; b < N_BINS - 1; ++b) {
                acc += bin_cnt[b];
                for (int c = 0; c < 3; ++c) {
                    llo[c] = std::min(llo[c], blo[b][c]);
                    lhi[c] = std::max(lhi[c], bhi[b][c]);
                }
                float dx = std::max(lhi[0] - llo[0], 0.f),
                      dy = std::max(lhi[1] - llo[1], 0.f),
                      dz = std::max(lhi[2] - llo[2], 0.f);
                area_l[b] = dx * dy + dy * dz + dz * dx;
                cnt_l[b] = acc;
            }
            float rlo[3], rhi[3];
            for (int c = 0; c < 3; ++c) {
                rlo[c] = std::numeric_limits<float>::infinity();
                rhi[c] = -std::numeric_limits<float>::infinity();
            }
            acc = 0;
            for (int b = N_BINS - 1; b >= 1; --b) {
                acc += bin_cnt[b];
                for (int c = 0; c < 3; ++c) {
                    rlo[c] = std::min(rlo[c], blo[b][c]);
                    rhi[c] = std::max(rhi[c], bhi[b][c]);
                }
                float dx = std::max(rhi[0] - rlo[0], 0.f),
                      dy = std::max(rhi[1] - rlo[1], 0.f),
                      dz = std::max(rhi[2] - rlo[2], 0.f);
                float area_r = dx * dy + dy * dz + dz * dx;
                int k = b - 1;
                if (cnt_l[k] == 0 || acc == 0) continue;
                float cost = area_l[k] * cnt_l[k] + area_r * acc;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = k;
                }
            }
        }

        left_idx.reserve(cnt / 2);
        right_idx.reserve(cnt / 2);
        if (best_axis < 0) {
            // degenerate centroids: median split
            left_idx.assign(idx.begin(), idx.begin() + cnt / 2);
            right_idx.assign(idx.begin() + cnt / 2, idx.end());
        } else {
            float inv = N_BINS / (chi[best_axis] - clo[best_axis]);
            for (int32_t i : idx) {
                int b = std::min(
                    (int)((centroid[3 * i + best_axis] - clo[best_axis]) * inv),
                    N_BINS - 1);
                (b <= best_bin ? left_idx : right_idx).push_back(i);
            }
            if (left_idx.empty() || right_idx.empty()) {
                left_idx.clear();
                right_idx.clear();
                left_idx.assign(idx.begin(), idx.begin() + cnt / 2);
                right_idx.assign(idx.begin() + cnt / 2, idx.end());
            }
        }
    }

    int32_t build(std::vector<int32_t>& idx) {
        int32_t me = (int32_t)nodes.size();
        nodes.emplace_back();
        node_bounds(idx, nodes.back());
        const size_t cnt = idx.size();
        if ((int)cnt <= leaf_size) {
            BuildNode& n = nodes[me];
            n.first = (int32_t)order.size();
            n.count = (int32_t)cnt;
            order.insert(order.end(), idx.begin(), idx.end());
            return me;
        }

        std::vector<int32_t> left_idx, right_idx;
        partition(idx, left_idx, right_idx);
        idx.clear();
        idx.shrink_to_fit();

        // DFS order: left subtree emitted immediately after this node
        int32_t l = build(left_idx);
        nodes[me].left = l;
        build(right_idx);
        return me;
    }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error. Output arrays must
// hold >= 2*T entries (lo/hi: 3 floats each).
int64_t mtpu_build_bvh(const float* prim_lo, const float* prim_hi, int64_t T,
                       int32_t leaf_size, float* out_lo, float* out_hi,
                       int32_t* out_skip, int32_t* out_first,
                       int32_t* out_count, int32_t* out_order) {
    if (T <= 0) return -1;
    Builder b;
    b.prim_lo = prim_lo;
    b.prim_hi = prim_hi;
    b.leaf_size = leaf_size;
    b.centroid.resize((size_t)T * 3);
    for (int64_t i = 0; i < T; ++i)
        for (int c = 0; c < 3; ++c)
            b.centroid[3 * i + c] = 0.5f * (prim_lo[3 * i + c] + prim_hi[3 * i + c]);
    b.nodes.reserve((size_t)(2.1 * T / std::max(1, leaf_size / 2) + 16));
    b.order.reserve((size_t)T);

    std::vector<int32_t> root_idx((size_t)T);
    for (int64_t i = 0; i < T; ++i) root_idx[(size_t)i] = (int32_t)i;

    // Parallel top levels (gkdtree.h:1040-1060 TreeBuilder threads role):
    // expand a small spine of SAH splits serially, then build each spine
    // leaf's subtree in its own thread with a private Builder, and stitch
    // the DFS blocks back together (identical output to the serial build:
    // the splits are the same and DFS emission is left-to-right).
    unsigned hw = std::thread::hardware_concurrency();
    if (hw > 1 && T >= 1 << 15) {
        struct SpineNode {
            BuildNode bn;
            int left = -1, right = -1;   // spine children, -1 = task leaf
            int task = -1;               // index into tasks
        };
        std::vector<SpineNode> spine;
        std::vector<std::vector<int32_t>> tasks;
        int target_tasks = (int)std::min<unsigned>(hw * 2, 16);

        // breadth-first expansion of the largest task until enough tasks
        struct Pending { int slot; std::vector<int32_t> idx; };
        spine.emplace_back();
        std::vector<Pending> frontier;
        frontier.push_back({0, std::move(root_idx)});
        while ((int)frontier.size() < target_tasks) {
            // pick the largest frontier entry
            size_t pick = 0;
            for (size_t i = 1; i < frontier.size(); ++i)
                if (frontier[i].idx.size() > frontier[pick].idx.size())
                    pick = i;
            if ((int)frontier[pick].idx.size() <= b.leaf_size * 4) break;
            Pending cur = std::move(frontier[pick]);
            frontier.erase(frontier.begin() + pick);
            b.node_bounds(cur.idx, spine[cur.slot].bn);
            std::vector<int32_t> li, ri;
            b.partition(cur.idx, li, ri);
            int ls = (int)spine.size(); spine.emplace_back();
            int rs = (int)spine.size(); spine.emplace_back();
            spine[cur.slot].left = ls;
            spine[cur.slot].right = rs;
            frontier.push_back({ls, std::move(li)});
            frontier.push_back({rs, std::move(ri)});
        }
        for (auto& f : frontier) {
            spine[f.slot].task = (int)tasks.size();
            tasks.push_back(std::move(f.idx));
        }

        // build every task subtree in parallel
        std::vector<Builder> subs(tasks.size());
        {
            std::vector<std::thread> pool;
            std::atomic<size_t> next{0};
            auto worker = [&]() {
                for (;;) {
                    size_t k = next.fetch_add(1);
                    if (k >= tasks.size()) return;
                    Builder& sb = subs[k];
                    sb.prim_lo = prim_lo;
                    sb.prim_hi = prim_hi;
                    sb.leaf_size = b.leaf_size;
                    sb.centroid = b.centroid;  // shared read-only copy
                    sb.build(tasks[k]);
                }
            };
            for (unsigned t = 0; t < std::min<unsigned>(hw, tasks.size()); ++t)
                pool.emplace_back(worker);
            for (auto& th : pool) th.join();
        }

        // stitch: DFS over the spine, emitting spine nodes and task blocks
        // with node/order offsets rebased
        std::function<int32_t(int)> emit = [&](int sslot) -> int32_t {
            const SpineNode& sn = spine[sslot];
            if (sn.task >= 0) {
                const Builder& sb = subs[sn.task];
                int32_t base = (int32_t)b.nodes.size();
                int32_t obase = (int32_t)b.order.size();
                for (const BuildNode& n : sb.nodes) {
                    BuildNode m = n;
                    if (m.left >= 0) m.left += base;
                    if (m.first >= 0) m.first += obase;
                    b.nodes.push_back(m);
                }
                b.order.insert(b.order.end(), sb.order.begin(), sb.order.end());
                return base;
            }
            int32_t me = (int32_t)b.nodes.size();
            b.nodes.push_back(sn.bn);
            int32_t l = emit(sn.left);
            b.nodes[me].left = l;
            emit(sn.right);
            return me;
        };
        emit(0);
    } else {
        b.build(root_idx);
    }

    const int64_t N = (int64_t)b.nodes.size();
    // subtree sizes -> skip links. Nodes are already in DFS order, so a
    // node's subtree occupies [i, skip) with skip computable by a reverse
    // sweep: leaves have size 1; internal i has size 1 + size(left) +
    // size(right) where left = i+1 and right = left + size(left).
    std::vector<int64_t> size(N, 1);
    for (int64_t i = N - 1; i >= 0; --i) {
        const BuildNode& n = b.nodes[(size_t)i];
        if (n.first < 0) {
            int64_t l = n.left;
            int64_t r = l + size[(size_t)l];
            size[(size_t)i] = 1 + size[(size_t)l] + size[(size_t)r];
        }
    }
    for (int64_t i = 0; i < N; ++i) {
        const BuildNode& n = b.nodes[(size_t)i];
        std::memcpy(out_lo + 3 * i, n.lo, 12);
        std::memcpy(out_hi + 3 * i, n.hi, 12);
        out_skip[i] = (int32_t)(i + size[(size_t)i]);
        out_first[i] = n.first;
        out_count[i] = n.count;
    }
    std::memcpy(out_order, b.order.data(), (size_t)T * 4);
    return N;
}

}  // extern "C"
