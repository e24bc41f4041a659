"""FlowGNN on the banded GAT path."""
