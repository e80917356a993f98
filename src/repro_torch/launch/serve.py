"""Serving entry point: batched decoding with offload-policy cache placement.

The counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \\
        --reduced --batch 2 --prompt-len 32 --gen 16 --policy dfu \\
        --device cpu

Without ``--device`` it serves on the card (``cuda:0``) and raises when
there is none.  ``--offload-config tuned.json`` serves inside a port
session running those settings (``OffloadConfig.load``); the session
report prints at exit.  ``--streams N`` serves N concurrent request
streams over shared weights: one worker thread per stream, each with its
own ``Server`` and its own offload session (``stream-<i>``), all drawing
on one :class:`~repro_torch.core.residency.SharedDevicePool` of
``--pool-mb`` MB (:func:`serve_streams`); the pool's per-tenant report
prints at exit.  Every worker launches on the default stream.  Weights
come from a seeded ``torch.Generator`` (seed 0), the prompt from seed 1;
both differ from the reference's JAX draws.  An enc-dec model
(whisper-tiny) gets ones-valued stub ``frames``, as the reference's
launcher feeds it; a VLM is served on its text alone, as there.
"""
from __future__ import annotations

import argparse
import threading


def serve_streams(model, params, scfg, prompt, n_tokens: int, streams: int,
                  pool, ocfg=None, device=None, extra=None) -> list:
    """Serve ``streams`` copies of ``prompt`` concurrently, one worker
    thread each, each with its own ``Server`` over the shared ``params``
    inside its own session (``name=f"stream-{i}"``, ``pool=pool``,
    ``intercept=False``, ``record_trace=False``).  Returns one
    ``(tokens, ServeStats, tenant row, (start, end))`` per stream: the
    tenant row is ``pool.tenant_stats()`` just before the session closed,
    and ``start``/``end`` are ``time.perf_counter()`` stamps around the
    stream's ``generate`` (with ``extra``, the family's stub inputs).
    The first worker error is re-raised."""
    import time

    from repro_torch.core import session as ses
    from repro_torch.core.config import OffloadConfig
    from repro_torch.train import Server

    ocfg = OffloadConfig(policy="dfu") if ocfg is None else ocfg
    results = [None] * streams
    errors = []

    def worker(idx: int) -> None:
        try:
            with ses.session(ocfg, device=device, record_trace=False,
                             intercept=False, name=f"stream-{idx}",
                             pool=pool) as s:
                srv = Server(model, params, scfg, device=device)
                t0 = time.perf_counter()
                out = srv.generate(prompt, n_tokens, extra)
                t1 = time.perf_counter()
                results[idx] = (out, srv.stats,
                                pool.tenant_stats().get(s.name), (t0, t1))
        except BaseException as exc:   # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"serve-stream-{i}")
               for i in range(streams)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--policy", default="dfu",
                    choices=["dfu", "memcopy", "pinned"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--offload-config", default="",
                    help="OffloadConfig JSON: serve inside a session "
                         "running these settings")
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent request streams, one session per "
                         "stream over a shared device pool")
    ap.add_argument("--pool-mb", type=int, default=256,
                    help="shared pool capacity for --streams > 1")
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import torch_dtype
    from repro_torch.core import memspace
    from repro_torch.core.config import OffloadConfig
    from repro_torch.models import get_config
    from repro_torch.models.registry import Model
    from repro_torch.train import Server, ServeConfig

    device = memspace.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model.from_config(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    scfg = ServeConfig(max_len=args.prompt_len + args.gen,
                       temperature=args.temperature,
                       offload_policy=args.policy,
                       cache_dtype=torch_dtype(cfg.dtype))
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1))
    extra = None
    if cfg.family == "encdec":
        extra = {"frames": torch.ones(
            (args.batch, cfg.encoder_seq, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=device)}
    if args.streams > 1:
        from repro_torch.core.residency import SharedDevicePool
        pool = SharedDevicePool(args.pool_mb << 20, name="serve")
        ocfg = (OffloadConfig.load(args.offload_config)
                if args.offload_config else None)
        results = serve_streams(model, params, scfg, prompt, args.gen,
                                args.streams, pool, ocfg, device, extra)
        print(f"arch={cfg.name} policy={args.policy} "
              f"streams={args.streams} pool={args.pool_mb}MB "
              f"device={device}")
        print(pool.report())
        for idx, (out, st, row, (t0, t1)) in enumerate(results):
            print(f"  stream-{idx}: generated {tuple(out.shape)} "
                  f"migrations={st.migrations} "
                  f"cache reuses={st.cache_reuses} "
                  f"({st.tokens / max(1e-9, t1 - t0):.1f} tok/s)")
            if row is not None:
                print(f"  stream-{idx}: " + " ".join(
                    f"{k}={v}" for k, v in sorted(row.items())))
        return 0
    srv = Server(model, params, scfg, device=device)
    session = None
    if args.offload_config:
        from repro_torch.core.session import Session
        session = Session(OffloadConfig.load(args.offload_config),
                          device=device).open()
    try:
        out = srv.generate(prompt, args.gen, extra)
    finally:
        if session is not None:
            print(session.report())
            session.close()
    s = srv.stats
    tps = s.tokens / max(1e-9, s.decode_s)
    print(f"arch={cfg.name} policy={args.policy} device={device}")
    print(f"generated {tuple(out.shape)} prefill={s.prefill_s:.3f}s "
          f"decode={s.decode_s:.3f}s ({tps:.1f} tok/s)")
    print(f"state moved: h->d {s.bytes_host_to_dev/1e6:.2f} MB, "
          f"d->h {s.bytes_dev_to_host/1e6:.2f} MB, "
          f"migrations={s.migrations}, cache reuses={s.cache_reuses}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
