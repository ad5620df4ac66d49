// Device-side control flow for a captured outer step: the conditional IF
// and WHILE nodes of a CUDA graph (CUDA 12.4 and later), opened from a
// stream that is being captured.
//
// The reference runs its outer step as one XLA program: the inner solve
// sits under a lax.cond (skip when the incoming iterate already passes tol)
// and its Anderson blocks in a lax.while_loop, so the host reads back once
// an outer iteration. The port captures the step into a CUDA graph
// (core/engine.py) and puts those two decisions on the card with these
// nodes:
//
//   cond_begin(parent, body, WHILE, flag) adds, at the parent stream's
//     capture point, a one-thread kernel that copies *flag into a new
//     condition handle, then the conditional node, and starts capturing
//     `body` into the node's body graph;
//   cond_end(body, handle, flag) ends that capture; for a WHILE node it
//     first appends the one-thread kernel again, so the body's last step
//     sets whether the body runs once more.
//
// A WHILE node tests its condition on entry and after each pass of the
// body, as lax.while_loop does. Nothing here allocates, synchronises or
// reads back; the kernels are one thread each.
#include <cuda_runtime.h>

namespace {

constexpr int kErrNotCapturing = -2;
constexpr int kErrVersion = -3;

#if CUDART_VERSION >= 12040
__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// the graph a stream is capturing into and its current capture point
cudaError_t capture_point(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                          size_t* n_deps, bool* active) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, graph, deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, graph, deps, n_deps);
#endif
  *active = status == cudaStreamCaptureStatusActive;
  return err;
}
#endif

}  // namespace

extern "C" {

// Open a conditional node (kind 0: IF, 1: WHILE) on `parent`, which must be
// capturing, gated by the device bool *flag, and start capturing `body`
// into the node's body graph. The node's handle goes to *handle.
int cond_begin(void* parent, void* body, int kind, const bool* flag,
               unsigned long long* handle) {
#if CUDART_VERSION >= 12040
  cudaStream_t ps = (cudaStream_t)parent;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  bool active = false;
  cudaError_t err = capture_point(ps, &graph, &deps, &n_deps, &active);
  if (err != cudaSuccess) return (int)err;
  if (!active) return kErrNotCapturing;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition_kernel<<<1, 1, 0, ps>>>(h, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_point(ps, &graph, &deps, &n_deps, &active);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = kind ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body, params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  *handle = (unsigned long long)h;
  return 0;
#else
  return kErrVersion;
#endif
}

// Close the body opened by cond_begin on `body`. With `flag` (a WHILE
// node), the body's last node sets the condition from *flag.
int cond_end(void* body, unsigned long long handle, const bool* flag) {
#if CUDART_VERSION >= 12040
  cudaStream_t bs = (cudaStream_t)body;
  if (flag != nullptr) {
    set_condition_kernel<<<1, 1, 0, bs>>>((cudaGraphConditionalHandle)handle, flag);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture(bs, &graph);
#else
  return kErrVersion;
#endif
}

// The CUDA runtime version this library was built against.
int runtime_version() { return CUDART_VERSION; }

}  // extern "C"
