// Native BVH8 collapse: flattened binary SAH BVH -> 8-wide node pages.
//
// This is the C++ twin of pbrt_tpu/ops/pallas_bvh8.py:collapse_to_bvh8
// (same slot-expansion / dominant-axis-sort / preorder-emission algorithm,
// identical output layout), moved to native code because the Python
// version's per-node recursion + per-chunk O(m) reverse sweeps dominate
// host build time on million-triangle scenes (reference counterpart: the
// BVH build runs in parallel C++, cpu/aggregates.cpp:363-379).
//
// Exported C ABI (ctypes):
//   int collapse_bvh8(const float* nodes_bin /* m x 8 */, long m,
//                     int max_leaf, long root, long prim_base,
//                     float* out_nodes /* cap_rows x 72 */, long cap_rows,
//                     long* n_out, int* depth_out);
// Returns 0 on success, 1 if cap_rows was exceeded.
//
// Binary node row layout (ops/bvh.py): [lo.xyz, hi.xyz, roff, meta] where
// meta>>2 = nprim (leaf iff nprim > 0); for a leaf roff = prim offset, for
// an interior node the children are (i+1, roff).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kWidth = 8;
constexpr int kNodeF = kWidth * 8 + 8;  // 72 floats per BVH8 node
constexpr float kBig = 3e38f;

struct Slot {
    long bin;  // binary node index
};

}  // namespace

// Subtree primitive ranges of every node of a flattened DFS binary BVH
// (same reverse sweep the collapse uses), exported so the host-side chunk
// partitioner doesn't pay a Python-loop O(m) pass per build.
extern "C" void bvh_subtree_ranges(const float* nodes_bin, long m,
                                   long* start_out, long* count_out) {
    for (long i = m - 1; i >= 0; i--) {
        long roff = std::lround(nodes_bin[i * 8 + 6]);
        long nprim = std::lround(nodes_bin[i * 8 + 7]) >> 2;
        if (nprim > 0) {
            start_out[i] = roff;
            count_out[i] = nprim;
        } else {
            long l = i + 1, r = roff;
            start_out[i] = std::min(start_out[l], start_out[r]);
            count_out[i] = count_out[l] + count_out[r];
        }
    }
}

extern "C" int collapse_bvh8(const float* nodes_bin, long m, int max_leaf,
                             long root, long prim_base, float* out_nodes,
                             long cap_rows, long* n_out, int* depth_out) {
    // subtree prim ranges: children follow parents in depth-first order,
    // so one reverse sweep sees children before parents
    std::vector<long> roff(m), nprim(m), start(m), count(m);
    std::vector<double> area(m);
    for (long i = 0; i < m; i++) {
        roff[i] = std::lround(nodes_bin[i * 8 + 6]);
        nprim[i] = std::lround(nodes_bin[i * 8 + 7]) >> 2;
        double d0 = std::max<double>(nodes_bin[i * 8 + 3] - nodes_bin[i * 8 + 0], 0.0);
        double d1 = std::max<double>(nodes_bin[i * 8 + 4] - nodes_bin[i * 8 + 1], 0.0);
        double d2 = std::max<double>(nodes_bin[i * 8 + 5] - nodes_bin[i * 8 + 2], 0.0);
        area[i] = d0 * d1 + d1 * d2 + d2 * d0;
    }
    for (long i = m - 1; i >= 0; i--) {
        if (nprim[i] > 0) {
            start[i] = roff[i];
            count[i] = nprim[i];
        } else {
            long l = i + 1, r = roff[i];
            start[i] = std::min(start[l], start[r]);
            count[i] = count[l] + count[r];
        }
    }
    auto is_leaf = [&](long i) { return nprim[i] > 0; };

    // iterative preorder emission: pop = assign next out row; interior
    // children are pushed in reverse slot order so they pop ascending —
    // identical indices to the recursive Python emit()
    struct Work {
        long bin;
        long parent_row;  // -1 for root
        int parent_slot;
        int depth;
    };
    std::vector<Work> stack;
    stack.push_back({root, -1, 0, 1});
    long n_out_rows = 0;
    int max_depth = 0;

    while (!stack.empty()) {
        Work w = stack.back();
        stack.pop_back();
        if (n_out_rows >= cap_rows) return 1;
        long my = n_out_rows++;
        max_depth = std::max(max_depth, w.depth);
        if (w.parent_row >= 0)
            out_nodes[w.parent_row * kNodeF + w.parent_slot * 8 + 6] =
                static_cast<float>(my);

        // expand slots: split the highest-area oversized slot until 8 wide,
        // then any interior slot (ties resolve to the first, like Python)
        long slots[kWidth];
        int ns = 1;
        slots[0] = w.bin;
        while (ns < kWidth) {
            int best = -1;
            double best_a = -1.0;
            for (int si = 0; si < ns; si++) {
                long b = slots[si];
                if (!is_leaf(b) && count[b] > max_leaf && area[b] > best_a) {
                    best = si;
                    best_a = area[b];
                }
            }
            if (best < 0) {
                for (int si = 0; si < ns; si++) {
                    long b = slots[si];
                    if (!is_leaf(b) && ns < kWidth && area[b] > best_a) {
                        best = si;
                        best_a = area[b];
                    }
                }
                if (best < 0) break;
            }
            long b = slots[best];
            // pop slot `best`, insert (b+1, roff[b]) at its position
            for (int k = ns; k > best + 1; k--) slots[k] = slots[k - 1];
            slots[best] = b + 1;
            slots[best + 1] = roff[b];
            ns++;
        }

        // sort children along the dominant axis of their union box
        double ulo[3] = {1e300, 1e300, 1e300};
        double uhi[3] = {-1e300, -1e300, -1e300};
        for (int si = 0; si < ns; si++) {
            for (int k = 0; k < 3; k++) {
                ulo[k] = std::min(ulo[k], (double)nodes_bin[slots[si] * 8 + k]);
                uhi[k] = std::max(uhi[k], (double)nodes_bin[slots[si] * 8 + 3 + k]);
            }
        }
        int axis = 0;
        double ext = uhi[0] - ulo[0];
        for (int k = 1; k < 3; k++)
            if (uhi[k] - ulo[k] > ext) {
                ext = uhi[k] - ulo[k];
                axis = k;
            }
        std::stable_sort(slots, slots + ns, [&](long a, long b) {
            return (double)nodes_bin[a * 8 + axis] + nodes_bin[a * 8 + 3 + axis] <
                   (double)nodes_bin[b * 8 + axis] + nodes_bin[b * 8 + 3 + axis];
        });

        float* row = out_nodes + my * kNodeF;
        std::memset(row, 0, kNodeF * sizeof(float));
        row[kWidth * 8] = static_cast<float>(axis);
        if (my == 0) {
            // root: union box in the pad floats (whole-block pre-test)
            for (int k = 0; k < 3; k++) {
                row[kWidth * 8 + 1 + k] = static_cast<float>(ulo[k]);
                row[kWidth * 8 + 4 + k] = static_cast<float>(uhi[k]);
            }
        }
        for (int c = kWidth - 1; c >= 0; c--) {
            float* o8 = row + c * 8;
            if (c < ns) {
                long s = slots[c];
                for (int k = 0; k < 3; k++) {
                    o8[k] = nodes_bin[s * 8 + k];
                    o8[3 + k] = nodes_bin[s * 8 + 3 + k];
                }
                if (is_leaf(s) || count[s] <= max_leaf) {
                    o8[6] = static_cast<float>(start[s] - prim_base);
                    o8[7] = static_cast<float>(count[s]);
                } else {
                    // child index patched when the child pops; reverse-order
                    // push makes children pop in ascending slot order
                    o8[7] = 0.0f;
                    stack.push_back({s, my, c, w.depth + 1});
                }
            } else {
                o8[0] = o8[1] = o8[2] = kBig;
                o8[3] = o8[4] = o8[5] = -kBig;
                o8[6] = 0.0f;
                o8[7] = -1.0f;  // EMPTY
            }
        }
    }
    *n_out = n_out_rows;
    *depth_out = max_depth;
    return 0;
}
