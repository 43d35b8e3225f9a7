// K8's gate — the step graph's conditional node.
//
// The JAX package's fixpoint loop (cruise_control_tpu/analyzer/optimizer.py
// :1628-1659, a lax.while_loop) tests its cond and never enters the body
// once the goal has converged or spent its budget.  On the card the port
// replays one CUDA graph per gated step (analyzer/graphs.py); this source
// makes that graph skip the step the same way:
//
//   [gate kernel] -> [IF node: the step body, captured by torch]
//
// cc_step_graph_build takes the step body's captured graph (a cudaGraph_t
// that torch kept), makes a new graph whose first node is step_gate_kernel
// and whose second is a conditional IF node holding the body as a child
// graph, instantiates it and returns the executable.  step_gate_kernel is
// one thread: it reads the step counters (state.py CTR_*), sets the IF
// node's condition to ``last_n > 0 and steps < budget`` and, when it is
// set, adds one to the graph's count of executed steps (``executed``,
// u64), so the host can credit the body's kernel launches to the steps
// that ran (graphs.StepGraph).  A gated-off replay runs this one kernel and
// an empty conditional.
//
// The body holds kernels, memsets and device-to-device copies, which a
// conditional body accepts; a node it does not accept (a host node, an
// event node, a host copy) makes the instantiation fail, and the build
// returns that error: there is no unconditional graph to fall back to.
//
// cc_step_graph_launch replays an executable on PyTorch's current stream;
// cc_step_graph_destroy frees it.  All three take the stream last, as every
// C entry of the port does (ops/cuda.py); build and destroy ignore it.
//
// Bound: the gate reads 12 bytes and writes 8: launch-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// state.py CTR_* slots.
constexpr int kSteps = 0, kLastN = 2, kBudget = 6;

__global__ void step_gate_kernel(const int32_t* __restrict__ counters,
                                 unsigned long long* __restrict__ executed,
                                 cudaGraphConditionalHandle handle) {
  const bool active = counters[kLastN] > 0 && counters[kSteps] < counters[kBudget];
  if (active) ++*executed;
  cudaGraphSetConditional(handle, active ? 1u : 0u);
}

}  // namespace

extern "C" int cc_step_graph_build(void* body, const int32_t* counters,
                                   unsigned long long* executed, void** exec_out,
                                   cudaStream_t /*unused*/) {
  if (!body || !counters || !executed || !exec_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle{};
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  cudaGraphNode_t gate = nullptr, cond = nullptr, child = nullptr;
  if (err == cudaSuccess) {
    void* args[] = {&counters, &executed, &handle};
    cudaKernelNodeParams kp{};
    kp.func = reinterpret_cast<void*>(step_gate_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&gate, graph, nullptr, 0, &kp);
  }
  cudaGraphNodeParams cp{};
  if (err == cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    err = cudaGraphAddNode(&cond, graph, &gate, 1, &cp);
  }
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0], nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky-free error state for the caller
    return static_cast<int>(err);
  }
  *exec_out = exec;
  return 0;
}

extern "C" int cc_step_graph_launch(void* exec, cudaStream_t stream) {
  if (!exec) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), stream));
}

extern "C" int cc_step_graph_destroy(void* exec, cudaStream_t /*unused*/) {
  if (!exec) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
