// CUDA graph WHILE nodes for the gated line-search driver
// (linesearch/strategies.py::_gated, kernels/graph_if.py::GraphGate).
//
// Replaces no TPU kernel.  The reference runs each line search as a
// lax.while_loop on the device (tpu_lbfgs/linesearch/strategies.py); the
// port captures one turn of each search loop into the body of a WHILE node
// of the block's CUDA graph, so that a replay runs the turn while the
// search runs, with no host read.  Torch's own capture methods for
// conditional nodes are missing from some releases (the card's among
// them), so the port adds the node itself through the runtime API:
//
//   tl_graph_while_begin  on `parent`, the stream capturing the block's
//                         graph: a kernel that sets a new conditional
//                         handle from the bool at `pred` (and counts the
//                         turn), then a WHILE node on that handle after
//                         what has been captured; the stream goes on after
//                         the node.  `body` starts capturing the turn into
//                         a graph of its own; `*body_graph` is the node's
//                         body graph and `*handle` its handle.
//   tl_graph_while_end    ends the capture of `body`, puts what it
//                         captured into `body_graph` as one child graph
//                         node, and after it a kernel node of the body
//                         graph's own that sets `handle` again from `pred`,
//                         which the turn has rewritten (and counts the next
//                         turn): the loop's condition, read where the
//                         turn ends.
//   tl_capture_abort      ends the capture of `stream`, destroys what it
//                         captured and clears the runtime's last error (a
//                         capture that broke: the error has been raised).
//   tl_capture_nodes      adds the nodes of the graph `stream` is capturing
//                         to `*nodes` (the end entry adds those of each
//                         body, its condition kernel included): a
//                         measurement of a block's graph.
//
// A turn is captured into a graph of its own and added whole once its
// capture has ended: a capture that breaks (an objective that reads the
// host) leaves the node's body empty and the block's graph whole, so that
// the block's capture can be ended and dropped, where a body captured in
// place is left undefined (ending or destroying the block's capture then
// faulted on the card).
//
// The condition kernel is one thread: it reads one byte and writes the
// handle and one 8-byte counter, a launch's latency and nothing else.
#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred, long long* turns) {
  const bool go = *pred;
  cudaGraphSetConditional(handle, go ? 1u : 0u);
  if (go && turns != nullptr) *turns += 1;
}

cudaError_t count_nodes(cudaGraph_t graph, long long* nodes) {
  size_t n = 0;
  const cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes += static_cast<long long>(n);
  return err;
}

cudaError_t capture_nodes(cudaStream_t stream, long long* nodes) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  return count_nodes(graph, nodes);
}

}  // namespace

extern "C" int tl_capture_nodes(void* stream, long long* nodes) {
  return capture_nodes(static_cast<cudaStream_t>(stream), nodes);
}

extern "C" int tl_capture_abort(void* stream) {
  cudaGraph_t graph = nullptr;
  const cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
  if (graph != nullptr) cudaGraphDestroy(graph);
  (void)cudaGetLastError();
  return err;
}

extern "C" int tl_stream_create(void** out) {
  cudaStream_t stream = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  *out = stream;
  return err;
}

extern "C" int tl_stream_destroy(void* stream) {
  return cudaStreamDestroy(static_cast<cudaStream_t>(stream));
}

extern "C" int tl_graph_while_begin(void* parent_ptr, const void* pred_ptr,
                                    void* turns_ptr, void* body_ptr,
                                    void** body_graph,
                                    unsigned long long* handle_out) {
  auto parent = static_cast<cudaStream_t>(parent_ptr);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, parent>>>(handle,
                                     static_cast<const bool*>(pred_ptr),
                                     static_cast<long long*>(turns_ptr));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, nullptr, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> after(deps, deps + n_deps);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, after.data(), after.size(), &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *body_graph = params.conditional.phGraph_out[0];
  *handle_out = handle;
  return cudaStreamBeginCapture(static_cast<cudaStream_t>(body_ptr),
                                cudaStreamCaptureModeThreadLocal);
}

extern "C" int tl_graph_while_end(void* body_ptr, void* body_graph_ptr,
                                  unsigned long long handle_value,
                                  const void* pred_ptr, void* turns_ptr,
                                  long long* nodes) {
  auto into = static_cast<cudaGraph_t>(body_graph_ptr);
  cudaGraph_t captured = nullptr;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_ptr), &captured);
  if (err != cudaSuccess) return err;
  err = count_nodes(captured, nodes);
  cudaGraphNode_t child;
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(&child, into, nullptr, 0, captured);
  cudaGraphDestroy(captured);
  if (err != cudaSuccess) return err;
  // The condition kernel as a node of the body graph itself, after the
  // turn: it reads the predicate the turn wrote.
  cudaGraphConditionalHandle handle = handle_value;
  auto pred = static_cast<const bool*>(pred_ptr);
  auto turns = static_cast<long long*>(turns_ptr);
  void* args[] = {&handle, &pred, &turns};
  cudaKernelNodeParams kernel = {};
  kernel.func = reinterpret_cast<void*>(set_condition);
  kernel.gridDim = dim3(1, 1, 1);
  kernel.blockDim = dim3(1, 1, 1);
  kernel.sharedMemBytes = 0;
  kernel.kernelParams = args;
  kernel.extra = nullptr;
  cudaGraphNode_t condition;
  err = cudaGraphAddKernelNode(&condition, into, &child, 1, &kernel);
  if (err == cudaSuccess) *nodes += 1;
  return err;
}
