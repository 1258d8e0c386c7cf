// Node count of a captured CUDA graph, for the capture record of
// models/pipeline.CapturedSchedule: torch.cuda.CUDAGraph(keep_graph=True)
// hands out its cudaGraph_t (raw_cuda_graph) before it is instantiated.
// Host code only; no kernel.

#include <cuda_runtime.h>
#include <stdint.h>

// *out: the graph's nodes.  Returns cudaGraphGetNodes' cudaError_t.
extern "C" int graph_node_count(void* graph, int64_t* out) {
  size_t n = 0;
  const cudaError_t rc =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *out = static_cast<int64_t>(n);
  return rc;
}
