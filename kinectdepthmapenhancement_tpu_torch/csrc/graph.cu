// The compiled call's graph (core/jit.py): the segments captured between
// the conditionals of a call, joined into one CUDA graph in which each
// lax.cond of the JAX package (ops/slic.py:1451 and :1467, models/
// pipelines.py:255) is a conditional node: IF with an ELSE body.
//
// core/jit.py captures a call as a chain of PyTorch CUDA graphs that share
// one memory pool, captured in order on one stream: segment 0, then for
// each conditional its two bodies and the next segment.  Here they become
//
//   child(segment 0) -> set(cond 0) -> IF cond 0 {child(if body 0)}
//                                      ELSE {child(else body 0)}
//   -> child(segment 1) -> ... -> child(segment n-1)
//
// where set(cond i) is a one-thread kernel that reads the verdict (a bool
// that segment i wrote on the device), sets the node's handle from it and
// counts the branch taken.  The host reads nothing: the branch is picked on
// the device at every replay.  Bounded by nothing worth counting: one
// thread reads one byte and writes one int a conditional.

#include <cuda_runtime.h>

#include <vector>

extern "C" const void* kde_stamp_symbol();  // csrc/stamp.cu

namespace {

__global__ void kde_set_condition(cudaGraphConditionalHandle handle, const bool* verdict,
                                  int* taken) {
  const unsigned int v = *verdict ? 1u : 0u;
  cudaGraphSetConditional(handle, v);
  taken[v ? 0 : 1] += 1;  // [IF taken, ELSE taken]
}

// `child` as a child graph node of `graph` after `dep` (none when null);
// an empty graph becomes an empty node
cudaError_t add_child(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
                      cudaGraph_t child) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(child, nullptr, &n);
  if (err != cudaSuccess) return err;
  const size_t ndep = dep ? 1 : 0;
  if (n == 0) return cudaGraphAddEmptyNode(node, graph, dep ? &dep : nullptr, ndep);
  return cudaGraphAddChildGraphNode(node, graph, dep ? &dep : nullptr, ndep, child);
}

// add the kernel nodes of `graph` to *kernels and those that run kde_stamp
// to *stamps, child graphs' included (a conditional node's bodies are
// graphs of their own: core/jit.py counts each body where it was captured)
cudaError_t count_kernels(cudaGraph_t graph, int* kernels, int* stamps) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  const void* stamp = kde_stamp_symbol();
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return err;
    if (type == cudaGraphNodeTypeKernel) {
      ++*kernels;
      cudaKernelNodeParams p = {};
      // a kernel of another module (a library's) may give no parameters
      // here: it is no stamp
      if (cudaGraphKernelNodeGetParams(node, &p) == cudaSuccess) {
        if (p.func == stamp) ++*stamps;
      } else {
        cudaGetLastError();
      }
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (err == cudaSuccess) err = count_kernels(child, kernels, stamps);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

#define KDE_TRY(expr)                        \
  do {                                       \
    const cudaError_t err_ = (expr);         \
    if (err_ != cudaSuccess) {               \
      if (graph) cudaGraphDestroy(graph);    \
      return static_cast<int>(err_);         \
    }                                        \
  } while (0)

// Join n segments and the n - 1 conditionals between them (verdict[i],
// taken[i] an int[2] on the device, if_body[i] / else_body[i] the captured
// bodies) into one graph and instantiate it into *exec_out.  The inputs
// are cloned: the caller keeps owning them.
extern "C" int kde_graph_assemble(int n, void* const* segments, void* const* if_bodies,
                                  void* const* else_bodies, void* const* verdicts,
                                  void* const* taken, void** exec_out) {
  cudaGraph_t graph = nullptr;
  KDE_TRY(cudaGraphCreate(&graph, 0));
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < n; ++i) {
    cudaGraphNode_t node;
    KDE_TRY(add_child(&node, graph, prev, static_cast<cudaGraph_t>(segments[i])));
    prev = node;
    if (i == n - 1) break;
    cudaGraphConditionalHandle handle;
    KDE_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
    const bool* verdict = static_cast<const bool*>(verdicts[i]);
    int* counts = static_cast<int*>(taken[i]);
    void* args[] = {&handle, &verdict, &counts};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(kde_set_condition);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    KDE_TRY(cudaGraphAddKernelNode(&node, graph, &prev, 1, &kp));
    prev = node;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 2;  // IF body, ELSE body
    KDE_TRY(cudaGraphAddNode(&node, graph, &prev, 1, &cp));
    prev = node;
    cudaGraphNode_t body;
    KDE_TRY(add_child(&body, cp.conditional.phGraph_out[0], nullptr,
                      static_cast<cudaGraph_t>(if_bodies[i])));
    KDE_TRY(add_child(&body, cp.conditional.phGraph_out[1], nullptr,
                      static_cast<cudaGraph_t>(else_bodies[i])));
  }
  cudaGraphExec_t exec = nullptr;
  KDE_TRY(cudaGraphInstantiate(&exec, graph, 0));
  cudaGraphDestroy(graph);
  *exec_out = exec;
  return 0;
}

#undef KDE_TRY

extern "C" int kde_graph_launch(void* exec, void* stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int kde_graph_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

// The kernel nodes of a captured graph (child graphs included) and, of
// them, the kde_stamp nodes.
extern "C" int kde_graph_count(void* graph, int* kernels, int* stamps) {
  *kernels = 0;
  *stamps = 0;
  return static_cast<int>(count_kernels(static_cast<cudaGraph_t>(graph), kernels, stamps));
}
