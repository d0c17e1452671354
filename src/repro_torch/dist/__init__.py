"""repro_torch.dist — the communication subsystem for WSP data parallelism
(the port of repro.dist; numpy and threading, no device code).

  compression  — sparsifying / quantizing codecs with error feedback
  topology     — heterogeneous cluster/link cost model (alpha-beta)
  collectives  — emulated ring / hierarchical reduction algorithms
  transport    — simulated per-link delay + byte accounting for the PS path
"""
from repro_torch.dist.compression import (      # noqa: F401
    ErrorFeedbackCompressor, Int8StochasticQuantizer, make_codec,
    topk_compress, topk_decompress,
)
from repro_torch.dist.topology import (         # noqa: F401
    ClusterTopology, LinkSpec, Pod, make_topology,
)
from repro_torch.dist.collectives import (      # noqa: F401
    ring_allreduce, ring_reduce_scatter, ring_all_gather,
    hierarchical_allreduce,
)
from repro_torch.dist.transport import (        # noqa: F401
    NullTransport, SimulatedTransport,
)
