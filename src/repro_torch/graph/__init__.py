# Graph workloads on the HBP path: GNN neighborhood aggregation is SpMM
# with a feature-matrix RHS, so the paper's kernels serve message passing
# directly.  graph.py builds/normalizes adjacencies (host side, numpy),
# aggregate.py wraps the SpMM combine monoids (sum/mean/max) as
# aggregation closures over staged tiles or served plans, and
# layers_gnn.py composes them into GCN / GraphSAGE / GAT forwards, and train/
# trains them (sampling, losses, the trainer) through the differentiable
# aggregators.
from .aggregate import (
    AGGREGATIONS,
    aggregate,
    make_aggregator,
    make_attention_aggregator,
    make_diff_aggregator,
    mean_divisor,
    plan_aggregator,
    plan_diff_aggregator,
)
from .graph import (
    add_self_loops,
    degrees,
    graph_from_edges,
    normalize_adjacency,
    power_law_graph,
    rmat_graph,
)
from .layers_gnn import (
    GAT,
    GCN,
    DenseParams,
    GATParams,
    GraphSAGE,
    SageParams,
    gat_forward,
    gat_layer,
    gcn_forward,
    gcn_layer,
    init_gat,
    init_gcn,
    init_sage,
    params_from_arrays,
    sage_forward,
    sage_layer,
)

__all__ = [
    "AGGREGATIONS",
    "aggregate",
    "make_aggregator",
    "make_diff_aggregator",
    "make_attention_aggregator",
    "mean_divisor",
    "plan_aggregator",
    "plan_diff_aggregator",
    "graph_from_edges",
    "add_self_loops",
    "degrees",
    "normalize_adjacency",
    "rmat_graph",
    "power_law_graph",
    "DenseParams",
    "SageParams",
    "GATParams",
    "GCN",
    "GraphSAGE",
    "GAT",
    "init_gcn",
    "init_sage",
    "init_gat",
    "params_from_arrays",
    "gcn_layer",
    "gcn_forward",
    "sage_layer",
    "sage_forward",
    "gat_layer",
    "gat_forward",
]
