// A CUDA graph with a device-side loop: the dispatch of the serving
// engine's mega window (gofr_tpu_torch/serving/programs.py::MegaGraph).
//
// Counterpart of: the lax.while_loop of gofr_tpu/serving/programs.py::
// mega_window, which runs up to m k-step decode windows in one dispatch and
// exits on the device when every slot's budget is covered or its EOS came.
// This is not a port of a Pallas kernel; it is the few CUDA runtime calls
// (CUDA >= 12.4) that give a CUDA graph the same loop:
//
//   [prologue] -> [set] -> WHILE(go) { [body] -> [set] }
//
// `prologue` and `body` are graphs captured by PyTorch (torch.cuda.CUDAGraph
// with keep_graph=True): the prologue zeroes the window counter and
// computes the first `go` flag, the body runs one k-step window, stores its
// tokens at the counter's offset, updates the budgets and recomputes `go`
// (an int32 in device memory). Each is added as a child graph node (the
// runtime clones it; the tensors it reads and writes stay where PyTorch's
// graph memory pool put them, and the caller keeps both captures alive).
// `set` is a one-thread kernel node that hands `go` to the conditional
// handle with cudaGraphSetConditional; the WHILE node runs its body graph
// again while the handle is nonzero. The handle is reset to 0 on every
// launch of the graph (cudaGraphCondAssignDefault), so a launch never
// inherits the last one's value. What bounds it: nothing measurable; it
// adds two one-thread kernels per window to a window of ~11,000 launches.

#include <cuda_runtime.h>

__global__ void gofr_while_set_kernel(cudaGraphConditionalHandle handle, const int* go) {
  cudaGraphSetConditional(handle, *go != 0 ? 1u : 0u);
}

namespace {

cudaError_t add_set_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                         cudaGraphConditionalHandle* handle, const int** go) {
  cudaKernelNodeParams p = {};
  void* args[2] = {handle, go};
  p.func = reinterpret_cast<void*>(gofr_while_set_kernel);
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, 1, &p);
}

}  // namespace

// Build and instantiate the loop graph around the two captured graphs.
// Returns a cudaError_t; on success *graph_out and *exec_out hold the new
// graph and its executable (free both with gofr_while_graph_destroy).
extern "C" int gofr_while_graph_build(void* prologue, void* body, const int* go,
                                      void** graph_out, void** exec_out) {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t pro_node, set0, loop, body_node, set1;
  cudaGraphNodeParams cond = {};
  cudaGraph_t body_graph;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return err;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) goto fail;
  err = cudaGraphAddChildGraphNode(&pro_node, graph, nullptr, 0,
                                   static_cast<cudaGraph_t>(prologue));
  if (err != cudaSuccess) goto fail;
  err = add_set_node(&set0, graph, &pro_node, &handle, &go);
  if (err != cudaSuccess) goto fail;
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = handle;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&loop, graph, &set0, nullptr, 1, &cond);
#else
  err = cudaGraphAddNode(&loop, graph, &set0, 1, &cond);
#endif
  if (err != cudaSuccess) goto fail;
  body_graph = cond.conditional.phGraph_out[0];
  err = cudaGraphAddChildGraphNode(&body_node, body_graph, nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) goto fail;
  err = add_set_node(&set1, body_graph, &body_node, &handle, &go);
  if (err != cudaSuccess) goto fail;
  err = cudaGraphInstantiate(&exec, graph, 0);
  if (err != cudaSuccess) goto fail;
  *graph_out = graph;
  *exec_out = exec;
  return cudaSuccess;
fail:
  cudaGraphDestroy(graph);
  return err;
}

extern "C" int gofr_while_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

extern "C" int gofr_while_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return err;
}
