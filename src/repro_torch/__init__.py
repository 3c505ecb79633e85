"""repro_torch — the PyTorch/CUDA port of the WCOJ dataflow engines.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and is held against it bit for bit.  It imports neither ``jax`` nor
``repro``.  It ports the local streaming
:class:`~repro_torch.api.GraphSession` over the binary edge relation and
n-ary relations of arity 3-4 (composite (hi, lo) keys), with hand-written
CUDA kernels (``csrc/``) for multi-region membership, the fused BiGJoin
level step, merge ranks and the epoch commit fold, each in a 1-word and a
composite variant::

    from repro_torch.api import GraphSession
    session = GraphSession(edges)               # on the card
    tri = session.register("triangle")
    res = session.update(batch, weights)        # one commit per epoch
    session.add_relation("tri", tri.enumerate()[0])
    session.update({"tri": (rows, weights)})    # a per-relation batch
"""
