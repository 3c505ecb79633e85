"""repro_torch — the PyTorch/CUDA port of the WCOJ dataflow engines.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and is held against it bit for bit.  It imports neither ``jax`` nor
``repro``.  The first slice ports the local streaming
:class:`~repro_torch.api.GraphSession` over the binary edge relation, with
hand-written CUDA kernels (``csrc/``) for multi-region membership, the
fused BiGJoin level step, merge ranks and the epoch commit fold::

    from repro_torch.api import GraphSession
    session = GraphSession(edges)               # on the card
    tri = session.register("triangle")
    res = session.update(batch, weights)        # one commit per epoch
"""
