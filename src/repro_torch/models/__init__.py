"""Model substrate of the port: the GNN family (``gnn``) and the layers it
needs (``layers``)."""
