// Native evaluation kernels for mindpose_tpu.
//
// Plays the role pycocotools' C extension plays for the reference
// (/root/reference/mindpose/engine/evaluator/evaluator.py:145-150 and
// utils/nms.py): the OKS pairwise matrix, greedy OKS-NMS and RLE expansion
// are the host-side hot loops of COCO keypoint evaluation. Exposed as plain
// extern "C" entry points consumed via ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -march=native -shared -fPIC csrc/coco_native.cpp -o
//        mindpose_tpu/utils/_coco_native.so
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// OKS between one gt and D detections (keypoints layout: x0,y0,v0,x1,...).
// When k1 == 0 (no labelled joints), distances fall back to the doubled
// gt-box clamp, matching pycocotools' computeOks.
void compute_oks_row(
    const double* gt,       // [K*3]
    const double* dts,      // [D, K*3]
    int64_t num_dts,
    int64_t num_kpts,
    double gt_area,
    const double* gt_bbox,  // [4] x,y,w,h (may be null when k1>0)
    const double* variances, // [K] (2*sigma)^2
    double* out)            // [D]
{
    std::vector<double> xg(num_kpts), yg(num_kpts);
    std::vector<int> vis(num_kpts);
    int64_t k1 = 0;
    for (int64_t k = 0; k < num_kpts; ++k) {
        xg[k] = gt[k * 3 + 0];
        yg[k] = gt[k * 3 + 1];
        vis[k] = gt[k * 3 + 2] > 0;
        k1 += vis[k];
    }
    double x0 = 0, x1 = 0, y0 = 0, y1 = 0;
    if (k1 == 0 && gt_bbox != nullptr) {
        x0 = gt_bbox[0] - gt_bbox[2];
        x1 = gt_bbox[0] + gt_bbox[2] * 2;
        y0 = gt_bbox[1] - gt_bbox[3];
        y1 = gt_bbox[1] + gt_bbox[3] * 2;
    }
    const double denom = (gt_area + 2.2e-16) * 2.0;
    for (int64_t d = 0; d < num_dts; ++d) {
        const double* det = dts + d * num_kpts * 3;
        double sum = 0.0;
        int64_t count = 0;
        for (int64_t k = 0; k < num_kpts; ++k) {
            if (k1 > 0) {
                if (!vis[k]) continue;
                const double dx = det[k * 3 + 0] - xg[k];
                const double dy = det[k * 3 + 1] - yg[k];
                sum += std::exp(-(dx * dx + dy * dy) / variances[k] / denom);
                ++count;
            } else {
                const double xd = det[k * 3 + 0];
                const double yd = det[k * 3 + 1];
                double dx = std::fmax(0.0, x0 - xd) + std::fmax(0.0, xd - x1);
                double dy = std::fmax(0.0, y0 - yd) + std::fmax(0.0, yd - y1);
                sum += std::exp(-(dx * dx + dy * dy) / variances[k] / denom);
                ++count;
            }
        }
        out[d] = count > 0 ? sum / count : 0.0;
    }
}

// Pairwise OKS for NMS: one instance vs N candidates with per-pair area
// averaging ((a_g + a_d)/2), matching the reference oks_iou (utils/nms.py:64).
void oks_iou_pairs(
    const double* g,        // [K*3]
    const double* d,        // [N, K*3]
    int64_t n,
    int64_t num_kpts,
    double a_g,
    const double* a_d,      // [N]
    const double* variances, // [K]
    double vis_thr,         // < 0 -> disabled
    double* out)            // [N]
{
    for (int64_t i = 0; i < n; ++i) {
        const double* det = d + i * num_kpts * 3;
        const double denom = ((a_g + a_d[i]) / 2.0 + 2.2e-16) * 2.0;
        double sum = 0.0;
        int64_t count = 0;
        for (int64_t k = 0; k < num_kpts; ++k) {
            if (vis_thr >= 0 && det[k * 3 + 2] <= vis_thr) continue;
            const double dx = det[k * 3 + 0] - g[k * 3 + 0];
            const double dy = det[k * 3 + 1] - g[k * 3 + 1];
            sum += std::exp(-(dx * dx + dy * dy) / variances[k] / denom);
            ++count;
        }
        out[i] = count > 0 ? sum / count
                           : (vis_thr >= 0 ? 0.0 : 0.0);
    }
}

// Column-major RLE expansion: counts alternate background/foreground runs.
// Returns 0 on success, -1 if counts don't sum to h*w.
int decode_rle(
    const int64_t* counts,
    int64_t num_counts,
    int64_t h,
    int64_t w,
    uint8_t* out)  // [h*w] row-major
{
    int64_t total = 0;
    for (int64_t i = 0; i < num_counts; ++i) total += counts[i];
    if (total != h * w) return -1;

    int64_t pos = 0;  // column-major position
    uint8_t val = 0;
    for (int64_t i = 0; i < num_counts; ++i) {
        for (int64_t j = 0; j < counts[i]; ++j) {
            const int64_t col = pos / h;
            const int64_t row = pos % h;
            out[row * w + col] = val;
            ++pos;
        }
        val ^= 1;
    }
    return 0;
}

}  // extern "C"
