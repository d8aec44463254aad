"""apex_tpu_torch.analysis — graph lint over the port's hot steps, the
collective and sharding census, and the kernels' launch lint.

Counterpart of ``apex_tpu/analysis/``, with its names, its expectation
schema and its record schema.  A graph is the aten graph of one call of a
step (:mod:`.graphs`: every operator, collective, kernel launch and host
sync it ran, plus its state's addresses and version counters), over which
the rule engine (:mod:`.core`, :mod:`.rules`) pins the invariants a
captured step depends on: no host sync, state updated in place (the
port's donation), operand dtypes by amp level, relayout-free channels
last, the exact collective pattern of each comm plan, the replication
ledger and the resharding census (:mod:`.sharding`, a run-time check
across the gloo ranks in the port).  :mod:`.pallas_lint` checks each
``ctypes`` kernel launch against what its source assumes.  The
registry (:mod:`.entry_points`) traces the real steps; findings export
as schema-versioned JSONL through ``observability.exporters``::

    python -m apex_tpu_torch.analysis            # lint every entry point
    python -m apex_tpu_torch.analysis --list     # what would run
    python -m apex_tpu_torch.analysis --tags serving --rules donation
"""

from .core import (Finding, Rule, RULES, register_rule, get_rule,
                   analyze, analyze_entry_point, findings_to_records,
                   run_lint, ERROR, WARNING)
from .graphs import (HOST_TRANSFER_PRIMS, COLLECTIVE_PRIMS, Graph, Trace,
                     Node, TensorMeta, trace_call, walk_graph, prim_nodes,
                     host_transfer_nodes, conv_nodes, large_dot_nodes,
                     transpose_nodes, collective_nodes, node_payload_bytes,
                     aliased_output_count, donated_arg_names,
                     duplicate_donated_leaves)
from .entry_points import (EntryPoint, ENTRY_POINTS, register_entry_point,
                           get, select, names, entry_point_memory_record,
                           prefetch)
from .sharding import (ArgSharding, CollectiveSite, RESHARD_PRIMS,
                       arg_shardings, collective_sites, check_mesh,
                       divergent_output_claims,
                       entry_point_sharding_record)
from .pallas_lint import (KernelSite, capture_kernel_sites, check_site,
                          collect_kernel_sites, lint_pallas_kernels)
from . import rules  # noqa: F401  (registers the core rule set)
from . import core
from . import graphs
from . import entry_points
from . import sharding
from . import pallas_lint

__all__ = [
    "Finding", "Rule", "RULES", "register_rule", "get_rule",
    "analyze", "analyze_entry_point", "findings_to_records",
    "run_lint", "ERROR", "WARNING",
    "HOST_TRANSFER_PRIMS", "COLLECTIVE_PRIMS", "Graph", "Trace", "Node",
    "TensorMeta", "trace_call", "walk_graph", "prim_nodes",
    "host_transfer_nodes", "conv_nodes", "large_dot_nodes",
    "transpose_nodes", "collective_nodes", "node_payload_bytes",
    "aliased_output_count", "donated_arg_names",
    "duplicate_donated_leaves",
    "EntryPoint", "ENTRY_POINTS", "register_entry_point", "get",
    "select", "names", "entry_point_memory_record", "prefetch",
    "ArgSharding", "CollectiveSite", "RESHARD_PRIMS", "arg_shardings",
    "collective_sites", "check_mesh", "divergent_output_claims",
    "entry_point_sharding_record",
    "KernelSite", "capture_kernel_sites", "check_site",
    "collect_kernel_sites", "lint_pallas_kernels",
    "rules", "core", "graphs", "entry_points", "sharding", "pallas_lint",
]
