"""FlowGNN on the banded path: GCN, GAT and GIN convolutions."""
