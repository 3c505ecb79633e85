"""Serving drivers of the port (the JAX package's ``repro.launch.serve``).

**LM decode**: batched prefill + greedy decode with a KV cache::

    python -m repro_torch.launch.serve --arch gemma2-2b --batch 4 --steps 32

**Streaming subgraph monitoring** (the paper's deployment, §5.3): load a
graph into a :class:`repro_torch.api.GraphSession`, register one or more
standing queries, then run the Delta-BiGJoin epoch loop ``normalize ->
dAQ_1..dAQ_n (every query) -> commit`` as edge updates stream in::

    python -m repro_torch.launch.serve --stream --query triangle,diamond \
        --scale 10 --epochs 12 --batch-size 512

and ``--concurrent N`` serves N tenants from their own client threads on
one :class:`repro_torch.serve.SessionPool`.  ``--workers N`` (N > 1)
serves both on a mesh of N workers (every region hash-sharded over them,
``--balance`` the BiGJoin-S Balance operator); ``--local`` keeps the
one-device session.  Every mode runs on ``--device`` (default the card;
``--device cpu`` runs the plain versions on the host).

``--backend gloo|nccl`` spreads the ``--workers`` workers of the stream
and concurrent modes over the ranks of ``torch.distributed.run``
(``launch.mesh.init_rank_mesh``; gloo may put every rank on one card,
NCCL puts one rank on each): every rank admits the tenants and serves,
rank 0 takes the stream's batches (the pool's ingress) and prints, and
``--durable-dir`` is rank 0's::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve --stream --workers 4 --backend gloo \
        --durable-dir build/serve --concurrent 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _mesh(args):
    """The mesh of the stream and concurrent modes: None (local), one
    process's of ``--workers`` workers on ``--device``, or this rank's
    over ``--backend`` (joined once)."""
    from repro_torch.launch.mesh import init_rank_mesh, make_host_mesh
    if args.local or args.workers <= 1:
        return None
    if args.backend:
        if getattr(args, "rank_mesh", None) is None:
            args.rank_mesh = init_rank_mesh(args.workers, args.backend,
                                            args.device)
        return args.rank_mesh
    return make_host_mesh(args.workers, args.device)


def _say(pool):
    """``print`` on rank 0 (or in one process), nothing elsewhere."""
    return print if pool.root else (lambda *a, **k: None)


def _pool(args, **kw):
    """The pool of the stream and concurrent modes: local, or a mesh of
    ``--workers`` workers on ``--device`` (over ranks with
    ``--backend``)."""
    from repro_torch.serve import SessionPool
    mesh = _mesh(args)
    return SessionPool(device=args.device, mesh=mesh, balance=args.balance,
                       update_batch=args.batch_size,
                       horizon=args.epochs * args.batch_size,
                       durable_dir=args.durable_dir,
                       snapshot_every=args.snapshot_every, **kw)


def _where(session) -> str:
    if session.local:
        return f"one {session.device.type} device"
    ranks = session.mesh.ranks
    return (f"a {session.w}-worker mesh on {session.device.type}"
            + (f" over {ranks} {session.mesh.backend} ranks"
               if ranks > 1 else "")
            + (" (balanced)" if session.balance else ""))


def serve_stream(args):
    """Single-tenant streaming monitor: a thin wrapper over the serving
    pool (DESIGN.md §9) — one tenant, coalesce=1, synchronous
    submit→result per logical epoch.  The prep/apply pipeline, admission
    prewarm and (``--durable-dir``) WAL+snapshot durability all come from
    :class:`repro_torch.serve.SessionPool`."""
    from repro_torch.api import Graph, oracle_count
    from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph
    from repro_torch.kernels import _build

    g = Graph.from_edges(rmat_graph(args.scale, args.edge_factor,
                                    seed=args.seed))
    names = [n.strip() for n in args.query.split(",") if n.strip()]
    # queries over the materialized ``tri`` relation (e.g. 4-clique-tri,
    # §5.4): a standing triangle query on the SAME session feeds the tri
    # relation — each logical epoch is then two session updates, edge batch
    # first, the resulting signed triangle delta second.  Registration and
    # tri seeding run inside the pool's admission ``setup`` hook so the
    # admission prewarm covers every standing query.
    state = {}

    def setup(session):
        handles = [session.register(n) for n in names]
        needs_tri = any(atom.rel == "tri"
                        for h in handles for atom in h.query.atoms)
        tri0 = None
        if needs_tri:
            feeder = session.register("triangle")
            tri0, _ = feeder.enumerate()
            session.add_relation("tri", tri0)
            if feeder not in handles:
                handles = [feeder] + handles
        state.update(handles=handles, needs_tri=needs_tri, tri0=tri0)

    pool = _pool(args, prewarm=args.prewarm)
    say = _say(pool)
    t0 = time.time()
    tenant = pool.admit("stream", g.edges, setup=setup, coalesce=1,
                        batch=args.bprime, out_capacity=args.out_capacity)
    t_admit = time.time() - t0
    session = tenant.session
    handles, needs_tri, tri0 = \
        state["handles"], state["needs_tri"], state["tri0"]
    stream = EdgeUpdateStream(g.num_vertices, args.batch_size,
                              insert_frac=args.insert_frac,
                              skew=args.stream_skew, seed=args.seed + 1)
    say(f"monitoring {', '.join(names)} over {g.num_edges:,} edges on "
        f"{_where(session)}; {args.epochs} epochs x "
        f"{args.batch_size} updates (one shared commit per epoch"
        + (", tri relation fed by the standing triangle query)"
           if needs_tri else ")"))
    if args.prewarm:
        say(f"prewarm: admitted in {t_admit:.1f}s "
            f"({tenant.stats.prewarm_compiles} compile events, kernel "
            f"libraries in {_build.build_dir()})")
    if args.durable_dir and session.epoch > 0:
        say(f"recovered epoch {session.epoch} from {args.durable_dir} "
            f"({tenant.stats.replayed} WAL epochs replayed)")

    times = []
    compiles = []
    noops = 0
    updates_sent = 0
    # the stream generator needs the live set to pick deletes; maintain it
    # from each epoch's normalized (ins, dels) instead of pulling
    # session.edges, an O(|E|) materialization of device state.  On a
    # mesh of ranks rank 0 submits; the other ranks serve its records
    # (pool.drain) until it drains too
    live = session.edges
    for step in range(args.epochs if pool.root else 0):
        upd, wts = stream.batch_at(step, live=live)
        t0 = time.time()
        res = tenant.submit(upd, wts).result()
        updates_sent += 1
        res2 = None
        if needs_tri:
            td = res.deltas["triangle"]
            t_upd = td.tuples if td.tuples is not None else \
                np.zeros((0, 3), np.int32)
            t_w = td.weights if td.weights is not None else \
                np.zeros(0, np.int32)
            res2 = tenant.submit({"tri": (t_upd, t_w)}).result()
            updates_sent += 1
            noops += int(res2.is_noop)
        dt = max(time.time() - t0, 1e-9)  # no-op epochs can be ~0s
        live = res.advance(live)  # host bookkeeping outside the timer
        times.append(dt)
        compiles.append(res.compile_events +
                        (res2.compile_events if res2 is not None else 0))
        noops += int(res.is_noop)
        parts = []
        changes = 0
        for h in handles:
            # a logical epoch's delta is the sum over both session updates
            # (edge-fed queries fire on the first, tri-fed on the second)
            ds = [res.deltas[h.name]]
            if res2 is not None:
                ds.append(res2.deltas[h.name])
            cd = sum(d.count_delta for d in ds)
            chg = sum(0 if d.weights is None else int(np.abs(
                d.weights).sum()) for d in ds)
            changes += chg
            parts.append(f"{h.name} {cd:+,}")
        say(f"  epoch {step}: {'  '.join(parts)} "
            f"({changes:,} changes) in {dt*1e3:.0f} ms — "
            f"{upd.shape[0]/dt:,.0f} upd/s, {changes/dt:,.0f} changes/s")
    pool.drain()
    st = session.stats
    if pool.root:
        warm = times[2:] or times
        warm_compiles = sum(compiles[2:]) if len(compiles) > 2 else 0
        p50, p99 = np.percentile(times, [50, 99])
        print(f"steady state: {np.median(warm)*1e3:.0f} ms/epoch, "
              f"{args.batch_size/np.median(warm):,.0f} upd/s; net "
              + " ".join(f"{h.name} {h.net_change:+,}" for h in handles)
              + f"; {st.commit_calls} commits / {st.normalize_calls} "
              f"normalizes over {st.epochs} epochs")
        print(f"latency: p50 {p50*1e3:.1f} ms  p99 {p99*1e3:.1f} ms  max "
              f"{max(times)*1e3:.1f} ms (p99/p50 "
              f"{p99/max(p50, 1e-9):.1f}x); compile events: "
              f"{st.prewarm_compiles} prewarm + {sum(compiles)} streaming "
              f"({warm_compiles} after warmup)")

    if args.verify:
        # collective reads on a mesh of ranks: every rank makes them, and
        # rank 0 checks
        rels_now = {"edge": session.edges}
        rels_0 = {"edge": g.edges}
        if needs_tri:
            rels_now["tri"] = session.relation("tri")
            rels_0["tri"] = tri0
        for h in handles if pool.root else ():
            ref = oracle_count(h.query, rels_now)
            ref0 = oracle_count(h.query, rels_0)
            if h.net_change != ref - ref0:  # not assert: survives python -O
                raise RuntimeError(
                    f"{h.name}: maintained total {h.net_change} != "
                    f"recompute diff {ref - ref0}")
            print(f"verified {h.name}: maintained total == recompute diff "
                  f"({ref:,} instances now) ✓")
        # one normalize per update, one commit per NON-no-op epoch,
        # regardless of how many standing queries are registered
        if pool.root and (st.normalize_calls != updates_sent or
                          st.commit_calls != updates_sent - noops or
                          st.commit_calls != st.epochs):
            raise RuntimeError(
                f"epoch contract violated: {st.commit_calls} commits / "
                f"{st.normalize_calls} normalizes for {updates_sent} "
                f"updates ({noops} no-ops)")
    pool.close()
    return sum(h.net_change for h in handles)


def serve_concurrent(args):
    """N-tenant concurrent serving demo: one :class:`SessionPool`, one
    device, ``--concurrent`` tenants each monitoring its own graph + update
    stream from its own client thread.  Prints the pool's aggregate stats
    (latency percentiles, coalescing, backpressure sheds, snapshot/replay
    counters, serving compile budget); ``--verify`` recomputes every
    tenant's maintained total from scratch at the end."""
    import threading

    from repro_torch.api import oracle_count
    from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph

    names = [n.strip() for n in args.query.split(",") if n.strip()]
    # admission prewarm is non-optional here: the multi-tenant serving
    # contract (DESIGN.md §9) is zero serving-path compile events, which
    # --verify asserts below
    pool = _pool(args, prewarm=True)
    graphs, tenants = {}, {}
    t0 = time.time()
    for i in range(args.concurrent):
        name = f"tenant{i}"
        graphs[name] = rmat_graph(args.scale, args.edge_factor,
                                  seed=args.seed + i)
        tenants[name] = pool.admit(
            name, graphs[name], queries=names, coalesce=args.coalesce,
            max_queue=args.max_queue, batch=args.bprime,
            out_capacity=args.out_capacity)
    say = _say(pool)
    where = f"one {pool.device.type} device" if pool.local else \
        f"a {pool.mesh.num_workers}-worker mesh on {pool.device.type}" + (
            f" over {pool.mesh.ranks} {pool.mesh.backend} ranks"
            if pool.mesh.ranks > 1 else "")
    say(f"admitted {len(tenants)} tenants ({', '.join(names)} each) on "
        f"{where} in {time.time()-t0:.1f}s; "
        f"{args.epochs} epochs x {args.batch_size} updates per tenant")

    # materialize each tenant's live mirror + epoch on THIS thread, before
    # any client submits: session.edges runs a device fold, and all device
    # work stays on the pool's apply thread once it is live (DESIGN.md §9)
    live0 = {name: tenants[name].session.edges for name in tenants}
    starts = {name: tenants[name].session.epoch for name in tenants}

    def client(name):
        # balanced stream (insert_frac 0.5): the live set stays near its
        # initial size
        stream = EdgeUpdateStream(
            1 << args.scale, args.batch_size, insert_frac=args.insert_frac,
            skew=args.stream_skew,
            seed=args.seed + 1 + len(tenants) + int(name[6:]))
        live = live0[name]
        start = starts[name]  # >0 after durable recovery
        for step in range(start, args.epochs):
            upd, wts = stream.batch_at(step, live=live)
            ticket = tenants[name].submit(upd, wts)
            if ticket is None:
                continue  # shed by backpressure
            live = ticket.result().advance(live)

    # on a mesh of ranks the clients are rank 0's, and the other ranks
    # serve its records until it drains
    threads = [threading.Thread(target=client, args=(n,), daemon=True)
               for n in (tenants if pool.root else ())]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    pool.drain()
    stats = pool.stats()
    say(stats.render())
    if args.verify:
        for name, handle in tenants.items():
            live = handle.session.edges  # a collective on a mesh of ranks
            for h in handle.session.handles.values() if pool.root else ():
                ref = oracle_count(h.query, {"edge": live})
                ref0 = oracle_count(h.query, {"edge": graphs[name]})
                if h.net_change != ref - ref0:
                    raise RuntimeError(
                        f"{name}/{h.name}: maintained total "
                        f"{h.net_change} != recompute diff {ref - ref0}")
            say(f"verified {name}: maintained totals == recompute ✓")
        if stats.serve_compiles:
            raise RuntimeError(
                f"{stats.serve_compiles} serving-path compile events "
                "(admission prewarm must cover the whole stream)")
    pool.close()
    return stats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_decode(model, prompts: torch.Tensor, steps: int):
    """Prefill ``prompts`` [B, S] on the model's device, copy the prefill's
    k/v into a cache of S + ``steps`` rows in place, then ``steps - 1``
    greedy decode steps.  Returns ``(prefill logits [B, V], tokens
    [B, steps] as numpy, last logits, prefill seconds, seconds per decode
    step)``."""
    from repro_torch.models import transformer as T
    cfg = model.cfg
    dev = prompts.device
    B, S = prompts.shape
    _sync(dev)
    t0 = time.time()
    logits, pcache = T.prefill(model, prompts)
    cache = T.make_cache(cfg, B, S + steps, device=dev)
    for part in ("k", "v"):
        cache[part][:, :, :S] = pcache[part].to(cache[part].dtype)
    del pcache
    first = logits
    tok = logits.argmax(-1)[:, None]
    _sync(dev)
    prefill_s = time.time() - t0
    out = [tok]
    t0 = time.time()
    for s in range(steps - 1):
        logits, cache = T.decode_step(model, cache, tok, S + s)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    step_s = (time.time() - t0) / max(steps - 1, 1)
    toks = torch.cat(out, 1).cpu().numpy()
    return first, toks, logits, prefill_s, step_s


def serve_lm(args):
    from repro_torch.configs.lm_archs import LM_ARCHS
    from repro_torch.core.csr import resolve_device
    from repro_torch.models import transformer as T

    specs = {a.arch_id: a for a in LM_ARCHS}
    if args.arch not in specs:
        raise KeyError(f"unknown LM arch {args.arch!r}; the port serves "
                       f"{', '.join(sorted(specs))}")
    spec = specs[args.arch]
    cfg = spec.full_config if args.full else spec.smoke_config
    dev = resolve_device(args.device)
    model = T.Transformer(cfg, seed=args.seed, device=dev)

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)).to(dev)
    _, toks, logits, prefill_s, step_s = greedy_decode(model, prompts,
                                                       args.steps)
    print(f"prefill {args.prompt_len} tokens in {prefill_s:.2f}s")
    print(f"decode: {step_s*1e3:.1f} ms/step, {args.batch/step_s:,.1f} "
          f"tok/s aggregate; sample: {toks[0][:16].tolist()}")
    if not torch.isfinite(logits.float()).all():
        raise RuntimeError("non-finite decode logits")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="LM arch to serve (decode mode)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of every mode (cpu: the plain versions)")
    # streaming subgraph monitor mode
    ap.add_argument("--stream", action="store_true",
                    help="serve a streaming subgraph monitor instead of an "
                    "LM (Delta-BiGJoin epoch loop)")
    ap.add_argument("--query", default="triangle",
                    help="comma list of named queries to monitor on ONE "
                    "shared session (stream mode)")
    ap.add_argument("--scale", type=int, default=10,
                    help="rmat scale of the base graph (stream mode)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=512,
                    help="updates per epoch (stream mode)")
    ap.add_argument("--insert-frac", type=float, default=0.75)
    ap.add_argument("--stream-skew", type=float, default=0.0,
                    help="zipf exponent for insert endpoints (0 = uniform)")
    ap.add_argument("--bprime", type=int, default=2048,
                    help="B' proposal budget (stream mode)")
    ap.add_argument("--out-capacity", type=int, default=1 << 20)
    ap.add_argument("--workers", type=int, default=1,
                    help="mesh workers of the stream and concurrent modes "
                    "(1: the one-device session)")
    ap.add_argument("--local", action="store_true",
                    help="the one-device session whatever --workers says")
    ap.add_argument("--balance", action="store_true",
                    help="BiGJoin-S Balance operator (the mesh's)")
    ap.add_argument("--prewarm", action="store_true",
                    help="admission prewarm: pin the delta and probe "
                    "marks and load every kernel library before the first "
                    "epoch (stream mode)")
    ap.add_argument("--verify", action="store_true",
                    help="check the maintained total against full "
                    "recomputation at the end (stream mode)")
    # concurrent serving (DESIGN.md §9): N tenants on one SessionPool
    ap.add_argument("--concurrent", type=int, default=0, metavar="N",
                    help="serve N tenants concurrently on one pool "
                    "(implies --stream semantics per tenant)")
    ap.add_argument("--coalesce", type=int, default=8,
                    help="max queued batches folded into one device epoch "
                    "per tenant (concurrent mode)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="per-tenant ingest queue bound — full queues "
                    "backpressure their own client only")
    ap.add_argument("--durable-dir", default=None,
                    help="WAL + snapshot directory: crash-killed serves "
                    "restore the last snapshot and replay the log "
                    "bit-exactly on restart")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="snapshot cadence in epochs (with --durable-dir)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="spread the --workers workers of the stream and "
                    "concurrent modes over the ranks of "
                    "torch.distributed.run")
    args = ap.parse_args(argv)
    if args.backend and (args.local or args.workers <= 1 or not (
            args.stream or args.concurrent)):
        ap.error("--backend serves the stream or concurrent mode on a "
                 "mesh: give --workers above 1 and no --local")

    try:
        if args.concurrent:
            return serve_concurrent(args)
        if args.stream:
            return serve_stream(args)
    finally:
        if args.backend:
            from repro_torch.launch.mesh import close_rank_mesh
            close_rank_mesh()
    if not args.arch:
        ap.error("--arch is required unless --stream is given")
    return serve_lm(args)


if __name__ == "__main__":
    main()
