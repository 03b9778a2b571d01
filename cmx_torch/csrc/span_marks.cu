// Span markers: the edges of the program's spans on the device timeline.
//
// cmx_torch.utils.profiling.span(name) launches one of these kernels on the
// stream of the span's tensors where the span opens and one where it closes
// (for a backward span: where its gradients start and end). A marker does
// nothing, with one thread; its name alone carries the span and the edge,
// `cmx::span_open_<name>` / `cmx::span_close_<name>`. A marker captured into
// a CUDA graph is replayed with it, so a device trace of replayed steps shows
// where every span opens and closes, on the device's own clock, where a host
// range would have run only once, at the capture.
//
// CMX_SPANS is the one list of span names: the kernels below are generated
// from it, and profiling.py reads its names from this line, in this order
// (the index a marker is launched by).

#include <cuda_runtime.h>

#define CMX_SPANS(X) \
  X(feed) X(views) X(forward) X(norm) X(loss) X(backward) X(optimizer) X(guard) \
  X(momentum)

namespace cmx {

#define CMX_MARKER_KERNELS(name)             \
  __global__ void span_open_##name() {}      \
  __global__ void span_close_##name() {}
CMX_SPANS(CMX_MARKER_KERNELS)
#undef CMX_MARKER_KERNELS

typedef void (*Marker)();

#define CMX_MARKER_PAIR(name) {span_open_##name, span_close_##name},
static const Marker kMarkers[][2] = {CMX_SPANS(CMX_MARKER_PAIR)};
#undef CMX_MARKER_PAIR

static const int kSpans = sizeof(kMarkers) / sizeof(kMarkers[0]);

}  // namespace cmx

// The number of spans CMX_SPANS lists.
extern "C" int cmx_span_count() { return cmx::kSpans; }

// Launch span `span`'s marker on `stream`: its open edge for close == 0,
// its close edge otherwise. Returns the launch's cudaGetLastError().
extern "C" int cmx_span_mark(int span, int close, void* stream) {
  if (span < 0 || span >= cmx::kSpans)
    return static_cast<int>(cudaErrorInvalidValue);
  cmx::kMarkers[span][close ? 1 : 0]<<<1, 1, 0,
                                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
