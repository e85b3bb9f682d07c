// Weighted box clustering: the greedy test-time consolidation loop
// (predictor.weighted_box_clustering) as a plain-C-ABI kernel, the port's
// copy of medicaldetectiontoolkit_tpu/native/wbc.cpp with the same ABI and
// the same code.
//
// The Python/NumPy version pays one interpreter round-trip per cluster
// seed; thousands of barely-overlapping detections per (patient, class)
// make the loop itself the cost. Semantics here mirror the NumPy code
// statement for statement in double precision: the legacy +1-pixel IoU
// row, greedy score-ordered consumption (the caller passes the NumPy
// argsort order so tie ordering is identical), expected-prediction
// down-weighting with unique patch-id counts, and the 0.01 score floor.
// Accumulation order differs from NumPy's pairwise summation only at the
// ~1e-15 relative level (pinned by tests/test_torch_native.py).

#include <cstdint>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// dets: (n, 2*dim+3) rows [coords..., score, center_factor, n_overlaps]
// patch_codes: (n,) integer codes of the box patch-id strings
// order: (n,) seed visitation order (scores argsort, descending)
// outputs: keep_scores (n,), keep_coords (n, 2*dim); *n_keep written last
void wbc_greedy(const double* dets, int64_t n, int32_t dim,
                const int64_t* patch_codes, const int64_t* order,
                double thresh, double n_ens,
                double* keep_scores, double* keep_coords, int64_t* n_keep) {
    const int64_t cols = 2 * dim + 3;
    const int64_t nc = 2 * dim;
    std::vector<double> area(n);
    for (int64_t i = 0; i < n; ++i) {
        const double* d = dets + i * cols;
        double a = (d[2] - d[0] + 1.0) * (d[3] - d[1] + 1.0);
        if (dim == 3) a *= d[5] - d[4] + 1.0;
        area[i] = a;
    }
    std::vector<char> consumed(n, 0);
    std::vector<double> iou(n);
    std::vector<int64_t> members;
    std::vector<int64_t> codes;
    int64_t kept = 0;

    for (int64_t oi = 0; oi < n; ++oi) {
        const int64_t s = order[oi];
        if (consumed[s]) continue;
        const double* ds = dets + s * cols;

        #pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n; ++i) {
            const double* d = dets + i * cols;
            double inter = std::max(0.0, std::min(ds[2], d[2]) - std::max(ds[0], d[0]) + 1.0)
                         * std::max(0.0, std::min(ds[3], d[3]) - std::max(ds[1], d[1]) + 1.0);
            if (dim == 3)
                inter *= std::max(0.0, std::min(ds[5], d[5]) - std::max(ds[4], d[4]) + 1.0);
            iou[i] = inter / (area[s] + area[i] - inter);
        }

        members.clear();
        for (int64_t i = 0; i < n; ++i)
            if (!consumed[i] && iou[i] > thresh) { members.push_back(i); consumed[i] = 1; }

        double w_sum = 0.0, ws_sum = 0.0, ov_sum = 0.0;
        for (int64_t m : members) {
            const double* d = dets + m * cols;
            const double w = iou[m] * area[m] * d[nc + 1];
            w_sum += w;
            ws_sum += d[nc] * w;
            ov_sum += d[nc + 2];
        }
        const double w_mean = w_sum / (double)members.size();

        codes.clear();
        for (int64_t m : members) codes.push_back(patch_codes[m]);
        std::sort(codes.begin(), codes.end());
        const int64_t n_unique =
            std::unique(codes.begin(), codes.end()) - codes.begin();

        const double n_expected = n_ens * (ov_sum / (double)members.size());
        const double n_missing = std::max(0.0, n_expected - (double)n_unique);
        const double avg_score = ws_sum / (w_sum + n_missing * w_mean);
        if (avg_score > 0.01) {
            keep_scores[kept] = avg_score;
            double* kc = keep_coords + kept * nc;
            for (int64_t c = 0; c < nc; ++c) {
                double acc = 0.0;
                for (int64_t m : members) {
                    const double* d = dets + m * cols;
                    acc += d[c] * (d[nc] * iou[m] * area[m] * d[nc + 1]);
                }
                kc[c] = acc / ws_sum;
            }
            ++kept;
        }
    }
    *n_keep = kept;
}

// 2D-slice detections -> 3D cubes (predictor.nms_2to3D). Greedy by caller-supplied score
// order; a cube takes the overlapping detections whose slices form a
// contiguous (gap <= 1) run with the seed's slice, and is cut at the first
// empty slice in either direction.
//
// dets: (n, 6) rows [y1, x1, y2, x2, score, slice_id]
// keep: (n,) seed indices; keep_z: (n, 2) [lo-1, hi+1] z extents
void nms_2to3d(const double* dets, int64_t n, const int64_t* order,
               double thresh, int64_t* keep, double* keep_z, int64_t* n_keep) {
    const int64_t cols = 6;
    std::vector<double> area(n);
    for (int64_t i = 0; i < n; ++i) {
        const double* d = dets + i * cols;
        area[i] = (d[2] - d[0] + 1.0) * (d[3] - d[1] + 1.0);
    }
    std::vector<char> consumed(n, 0);
    std::vector<char> overlapping(n);
    std::vector<double> occ;
    int64_t kept = 0;

    for (int64_t oi = 0; oi < n; ++oi) {
        const int64_t s = order[oi];
        if (consumed[s]) continue;
        const double* ds = dets + s * cols;

        occ.clear();
        for (int64_t i = 0; i < n; ++i) {
            overlapping[i] = 0;
            if (consumed[i]) continue;
            const double* d = dets + i * cols;
            const double inter =
                std::max(0.0, std::min(ds[2], d[2]) - std::max(ds[0], d[0]) + 1.0)
              * std::max(0.0, std::min(ds[3], d[3]) - std::max(ds[1], d[1]) + 1.0);
            if (inter / (area[s] + area[i] - inter) > thresh) {
                overlapping[i] = 1;
                occ.push_back(d[5]);
            }
        }
        std::sort(occ.begin(), occ.end());
        occ.erase(std::unique(occ.begin(), occ.end()), occ.end());
        // maximal gap<=1 run of occupied slices containing the seed's slice
        const double core = ds[5];
        int64_t pos = std::lower_bound(occ.begin(), occ.end(), core) - occ.begin();
        int64_t lo_i = pos, hi_i = pos;
        while (lo_i > 0 && occ[lo_i] - occ[lo_i - 1] <= 1.0) --lo_i;
        while (hi_i + 1 < (int64_t)occ.size() && occ[hi_i + 1] - occ[hi_i] <= 1.0) ++hi_i;
        const double lo = occ[lo_i], hi = occ[hi_i];

        for (int64_t i = 0; i < n; ++i)
            if (overlapping[i] && dets[i * cols + 5] >= lo && dets[i * cols + 5] <= hi)
                consumed[i] = 1;
        keep[kept] = s;
        keep_z[kept * 2] = lo - 1.0;
        keep_z[kept * 2 + 1] = hi + 1.0;
        ++kept;
    }
    *n_keep = kept;
}

}  // extern "C"
