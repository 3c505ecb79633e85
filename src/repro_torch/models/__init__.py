"""Model substrate of the port: the GNN family (``gnn``), the dense LM
family's forward and serving path (``transformer``) and the layers they
share (``layers``)."""
