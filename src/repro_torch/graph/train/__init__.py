# GNN training on the HBP path: neighbor sampling (host-side subgraph
# extraction + GraphSAGE fan-out), masked node-classification objectives,
# and a trainer that backpropagates through the differentiable aggregators
# (sum/mean backward = the transpose-adjacency SpMM, max = argmax routing).
from .loss import accuracy, softmax_cross_entropy
from .sampling import SampledSubgraph, sample_neighbors, subgraph
from .trainer import NodeClassifierTrainer, TrainState

__all__ = [
    "subgraph",
    "sample_neighbors",
    "SampledSubgraph",
    "softmax_cross_entropy",
    "accuracy",
    "NodeClassifierTrainer",
    "TrainState",
]
