// CUDA graph IF nodes for the gated line-search driver
// (linesearch/strategies.py::_gated, kernels/graph_if.py::GraphGate).
//
// Replaces no TPU kernel.  The reference runs each line search as a
// lax.while_loop on the device (tpu_lbfgs/linesearch/strategies.py); the
// port captures each turn of a search into the body of an IF node of the
// block's CUDA graph, so that a replay runs a turn only while the search
// runs, with no host read.  Torch's own capture methods for IF nodes
// (CUDAGraph.begin_capture_to_if_node) are missing from some releases, so
// the port adds the node itself through the runtime API:
//
//   tl_graph_if_begin  a kernel that sets a new conditional handle from
//                      the bool at `pred` (and counts the turn), then an
//                      IF node on that handle, after what has been
//                      captured; `body` starts capturing the turn's body
//                      into a graph of its own, and `*body_graph` is the
//                      node's body graph.  `parent` is the stream
//                      capturing the block's graph (the node joins it and
//                      the stream goes on after the node), or `body`
//                      itself, which is capturing an enclosing turn's
//                      body: that body is put into `into`, the enclosing
//                      node's body graph, and the new node after it, which
//                      nests the new node inside the enclosing body.
//   tl_graph_if_end    ends the capture of `body` and puts what it
//                      captured into `into`, as one child graph node.
//   tl_capture_abort   ends the capture of `stream`, destroys what it
//                      captured and clears the runtime's last error (a
//                      capture that broke: the error has been raised).
//   tl_capture_nodes   adds the nodes of the graph `stream` is capturing
//                      to `*nodes` (the begin and end entries add those of
//                      each body they put into its node): a measurement of
//                      a block's graph.
//
// A turn's body is captured into a graph of its own and added whole once
// its capture has ended: a capture that breaks (an objective that reads
// the host) leaves the node's body empty and the block's graph whole, so
// that the block's capture can be ended and dropped, where a body
// captured in place is left undefined (ending or destroying the block's
// capture then faulted on the card).
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

// Ends `body`'s capture and adds the captured graph to `into` as one child
// graph node, `*child`.
cudaError_t commit(cudaStream_t body, cudaGraph_t into, cudaGraphNode_t* child,
                   long long* nodes) {
  cudaGraph_t captured = nullptr;
  cudaError_t err = cudaStreamEndCapture(body, &captured);
  if (err != cudaSuccess) return err;
  err = count_nodes(captured, nodes);
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(child, into, nullptr, 0, captured);
  cudaGraphDestroy(captured);
  return err;
}

// On `stream`, capturing into `graph`: the condition kernel of a new
// handle of `graph`, then an IF node on it in `graph` after what the
// stream has captured.
cudaError_t add_if(cudaStream_t stream, cudaGraph_t graph, const bool* pred,
                   long long* turns, cudaGraphNode_t* node,
                   cudaGraph_t* body_graph) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, stream>>>(handle, pred, turns);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, nullptr, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> after(deps, deps + n_deps);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  err = cudaGraphAddNode(node, graph, after.data(), after.size(), &params);
  if (err != cudaSuccess) return err;
  *body_graph = params.conditional.phGraph_out[0];
  return cudaSuccess;
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

extern "C" int tl_graph_if_begin(void* parent_ptr, void* into_ptr,
                                 const void* pred_ptr, void* turns_ptr,
                                 void* body_ptr, void** body_graph,
                                 long long* nodes) {
  auto parent = static_cast<cudaStream_t>(parent_ptr);
  auto body = static_cast<cudaStream_t>(body_ptr);
  auto pred = static_cast<const bool*>(pred_ptr);
  auto turns = static_cast<long long*>(turns_ptr);
  cudaGraphNode_t node;
  cudaGraph_t new_body = nullptr;
  cudaError_t err;
  if (parent == body) {
    // Nested: the enclosing body into its node, then this node after it,
    // its condition kernel captured into the same graph.
    auto into = static_cast<cudaGraph_t>(into_ptr);
    cudaGraphNode_t child;
    err = commit(body, into, &child, nodes);
    if (err != cudaSuccess) return err;
    err = cudaStreamBeginCaptureToGraph(body, into, &child, nullptr, 1,
                                        cudaStreamCaptureModeThreadLocal);
    if (err != cudaSuccess) return err;
    err = add_if(body, into, pred, turns, &node, &new_body);
    cudaGraph_t ended = nullptr;
    const cudaError_t end = cudaStreamEndCapture(body, &ended);
    if (err != cudaSuccess) return err;
    if (end != cudaSuccess) return end;
  } else {
    cudaStreamCaptureStatus status;
    cudaGraph_t graph = nullptr;
    err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, nullptr,
                                   nullptr);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
    err = add_if(parent, graph, pred, turns, &node, &new_body);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                              cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
  }
  *body_graph = new_body;
  return cudaStreamBeginCapture(body, cudaStreamCaptureModeThreadLocal);
}

extern "C" int tl_graph_if_end(void* body, void* into, long long* nodes) {
  cudaGraphNode_t child;
  return commit(static_cast<cudaStream_t>(body), static_cast<cudaGraph_t>(into),
                &child, nodes);
}
