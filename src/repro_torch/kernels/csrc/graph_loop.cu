// The kNN schedule's loop as one CUDA graph: a WHILE conditional node
// whose body is one captured round of the certified growing-radius
// schedule followed by knn_loop_cond, the loop's condition.
//
// Replaces the control of the reference's lax.while_loop in
// src/repro/core/executor.py (_knn_rounds, :180-201: cond ~all(done) &
// rounds < max_rounds, rounds + 1 at the end of each body).  That loop
// is not a Pallas kernel; what it costs the card is a launch a round, so
// the design keeps the decision on the card: the host launches the graph
// once, the WHILE node re-runs the body while knn_loop_cond sets the
// node's condition to 1, and nothing reaches the host until the loop
// ends.
//
// knn_loop_cond is one thread: it reads B bools (done) and two ints, far
// under any bound worth a wider kernel (B is a query batch, 1 to a few
// thousand); its cost is the node's launch, a few microseconds.
//
// The body is a graph captured by PyTorch (CUDAGraph(keep_graph=True)),
// added here as a child graph node: every allocation of the round lies
// in PyTorch's private pool, captured once on one stream, so one set of
// round temporaries serves every iteration.  A conditional body holds
// kernel, memset, memcpy, empty, child graph and conditional nodes, all
// on one device; graph_loop_build returns the CUDA error that refuses
// anything else (for example a body captured across devices).
//
// C interface (ctypes, kernels/_cuda.py HOST_FUNCS); every function
// returns a cudaError_t as int:
//   graph_loop_build(body, done, B, rounds, max_rounds, flag,
//                    &graph, &exec)    body: cudaGraph_t or NULL (the
//                                      WHILE body is then the condition
//                                      alone: rounds counts to
//                                      max_rounds, or to 1 once every
//                                      query is done)
//   graph_loop_launch(exec, stream)
//   graph_loop_destroy(graph, exec)
#include <cuda_runtime.h>

// rounds += 1; flag = (some done[i] is 0) && rounds < max_rounds; the
// WHILE node runs its body again iff flag is 1.  The node's condition
// starts at 1 on every launch (cudaGraphCondAssignDefault), so the
// first round always runs, as the reference's cond holds before its
// first round (done is all false then).
__global__ void knn_loop_cond(cudaGraphConditionalHandle handle,
                              const bool* done, int B, int* rounds,
                              int max_rounds, int* flag) {
  const int r = *rounds + 1;
  *rounds = r;
  int open = 0;
  for (int i = 0; i < B; ++i) {
    if (!done[i]) {
      open = 1;
      break;
    }
  }
  const int v = open && r < max_rounds;
  *flag = v;
  cudaGraphSetConditional(handle, (unsigned int)v);
}

static int build_into(cudaGraph_t graph, cudaGraph_t body, const bool* done,
                      int B, int* rounds, int max_rounds, int* flag) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(
      &handle, graph, 1, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t loop_node;
  err = cudaGraphAddNode(&loop_node, graph, nullptr, 0, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t loop_body = params.conditional.phGraph_out[0];

  cudaGraphNode_t round_node;
  size_t n_deps = 0;
  if (body != nullptr) {
    err = cudaGraphAddChildGraphNode(&round_node, loop_body, nullptr, 0,
                                     body);
    if (err != cudaSuccess) return err;
    n_deps = 1;
  }
  void* args[] = {&handle, &done, &B, &rounds, &max_rounds, &flag};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)knn_loop_cond;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t cond_node;
  return cudaGraphAddKernelNode(&cond_node, loop_body,
                                n_deps ? &round_node : nullptr, n_deps, &kp);
}

extern "C" int graph_loop_build(void* body, void* done, int B, void* rounds,
                                int max_rounds, void* flag, void** graph_out,
                                void** exec_out) {
  *graph_out = nullptr;
  *exec_out = nullptr;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return err;
  err = (cudaError_t)build_into(graph, (cudaGraph_t)body,
                                (const bool*)done, B, (int*)rounds,
                                max_rounds, (int*)flag);
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    cudaGetLastError();  // leave no sticky error for the next launch check
    return err;
  }
  *graph_out = graph;
  *exec_out = exec;
  return cudaSuccess;
}

extern "C" int graph_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int graph_loop_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph != nullptr) {
    cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (err == cudaSuccess) err = e2;
  }
  return err;
}
