"""One run of one cell: set-up, the measured window, the check, the metrics.

Set-up (counted in ``setup_s``, from the first line of ``run.py``): the card,
the key material drawn from the seed on the device, the program's server
key (``tfhe_tpu_torch.make_server_key``, the deterministic core of its
keygen), the key form the cell's impl reads (``with_key_form``), the pool of
input ciphertexts the cell's client encrypts, and two warm requests at the
cell's own shapes (the first loads, or on a checkout's first run builds, the
kernels).

The window: the client's requests in a closed loop, one in flight, each
synchronised before the next is issued, until ``seconds`` have passed; the
request that is running then is finished and counted.  Every output is kept.

The check, once the window has closed, the peak memory read and the program's
keys freed: the reference derives its own keys from the same draws and the
client compares (``clients/*.py``).  Its numbers and limits are printed last
on standard error and last in the result line.

A cell on W > 1 cards runs as W ranks (``ranks.py``), this process rank 0 on
``cuda:0``: set-up starts the others and opens their store (``spawn_s``),
joins them in one process group once rank 0 has its keys (``join_s``, which
waits for the slowest rank) and broadcasts rank 0's server key, from which
each rank forms its impl's key form on its own card (``replicate_s``); every rank then
builds the client, warms it and runs each request rank 0 announces.  Rank 0
alone draws, keeps the clock and the outputs, and checks once the others have
ended.  The result's ``device`` then counts W cards: the fullest card's
memory peak, and each card's own figures under ``cards``.
"""

from __future__ import annotations

import dataclasses
import json
import random
import statistics
import sys
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

import tfhe_tpu_torch as tfhe
from benchmark.benchlib import card as bcard
from benchmark.benchlib import guard, ranks, spec
from benchmark.benchlib.trace import REQUEST, TraceSummary, summed, traced
from benchmark.reference import tfhe_ref as ref


def log(*parts) -> None:
    print("benchmark:", *parts, file=sys.stderr, flush=True)


@dataclass
class Context:
    """What a client reads: the cell, the device, the seed's generator, the
    configuration and the program's server key; on more than one card, the
    mesh of every rank's card and this rank's place (ranks other than 0
    have no generator and no secret key)."""

    cell: spec.Cell
    device: torch.device
    seed: int
    p: ref.Params
    impl: str
    gen: torch.Generator | None
    lwe_sk: torch.Tensor | None
    sk: object = None
    mesh: object = None
    rank: int = 0


@dataclass
class Served:
    request: object
    t_issue: float
    t_done: float
    units: int
    pbs_batches: tuple
    outputs: object = None


@dataclass
class Run:
    """What a metric reader reads."""

    cell: spec.Cell
    p: ref.Params
    card: str
    setup: dict
    served: list
    window_s: float
    trace: TraceSummary | None = None
    #: on more than one card, each card's own summary (``trace`` sums them)
    card_traces: list | None = None


def program_params(p: ref.Params):
    """The configuration as the program's parameter object."""
    dec = tfhe.DecomposerParams
    return tfhe.TfheParams(
        glwe_dimension=p.glwe_dimension, log_degree=p.log_degree,
        lwe_dimension=p.lwe_dimension, padding_bits=p.padding_bits, log_p=p.log_p,
        log_q=p.log_q, ks_decomposer=dec(p.ks_log_base, p.ks_levels, p.log_q),
        pbs_decomposer=dec(p.pbs_log_base, p.pbs_levels, p.log_q),
        lwe_std_dev=p.lwe_std_dev, glwe_std_dev=p.glwe_std_dev, name=p.name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _built_libraries() -> int:
    build = spec.ROOT / "build" / "tfhe_tpu_torch"
    return len(list(build.glob("*.so"))) if build.is_dir() else 0


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def _tensors(outputs) -> list:
    return [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)


def _reserve_for_outputs(outputs, seconds: float, request_s: float) -> None:
    """Let the allocator hold, before the window, the blocks for every output
    the window keeps (one request's ``outputs`` times the requests that fit
    in ``seconds`` at ``request_s`` each, and a quarter more), so that no
    allocation inside the window has to ask the card for memory."""
    count = int(1.25 * seconds / max(request_s, 1e-3)) + 8
    held = [torch.empty_like(t) for _ in range(count) for t in _tensors(outputs)]
    del held


def _timed(setup: dict, label: str, device: torch.device, fn):
    """``fn()``, with its seconds up to a synchronised card stored as ``setup[label]``."""
    t = time.perf_counter()
    out = fn()
    _sync(device)
    setup[label] = time.perf_counter() - t
    return out


def _set_up(cell, seed: int, seconds: float, device: torch.device, impl: str, setup: dict,
            group: ranks.Ranks | None = None):
    """The card, the key material, the program's keys, the client's pool and
    two warm requests; with ``group``, the ranks joined and the key
    replicated before the pool.  Returns the context, the client and the
    header of the ranks' requests (None on one card)."""
    p = ref.params_from_config(cell.config_name, cell.config)
    if device.type == "cuda":
        _timed(setup, "cuda_init_s", device,
               lambda: (torch.cuda.set_device(device), torch.zeros(1, device=device)))
    gen = _generator(device, seed)
    draws = _timed(setup, "draws_s", device, lambda: ref.draw_keys(p, gen))
    carried = [ref.to_carrier(x) for x in (draws.lwe_sk, draws.glwe_sk, draws.bk_a, draws.bk_e,
                                           draws.ksk_a, draws.ksk_e)]
    ctx = Context(cell=cell, device=device, seed=seed, p=p, impl=impl, gen=gen,
                  lwe_sk=draws.lwe_sk)
    del draws  # the check draws them again from the seed
    sk = _timed(setup, "keygen_s", device,
                lambda: tfhe.make_server_key(program_params(p), *carried))
    del carried
    ctx.sk = _timed(setup, "keyform_s", device, lambda: tfhe.with_key_form(sk, impl))
    del sk
    header = None
    if group is not None:
        header = _join(ctx, group.store, cell.chips, setup)
        _timed(setup, "replicate_s", device, lambda: _replicate(ctx))
    client = _timed(setup, "pool_s", device,
                    lambda: spec.client_class(cell.traffic["client"])(ctx))
    libraries = _built_libraries()
    for label in ("warm1_s", "warm2_s"):
        outputs = _timed(setup, label, device, lambda: _warm(client, header))
    setup["built_libraries"] = _built_libraries() - libraries
    _timed(setup, "reserve_s", device,
           lambda: _reserve_for_outputs(outputs, seconds, setup["warm2_s"]))
    return ctx, client, header


def _join(ctx: Context, store, world: int, setup: dict) -> ranks.Header:
    """Join the ranks' process group and build the (batch, model) = (world, 1)
    mesh on ``ctx``; returns the header of the ranks' requests."""
    from tfhe_tpu_torch.parallel.mesh import make_mesh

    def join():
        ranks.join(store, ctx.rank, world, ctx.device)
        ctx.mesh = make_mesh(batch=world, model=1, device=ctx.device)

    _timed(setup, "join_s", ctx.device, join)
    return ranks.Header(ctx.device)


def _replicate(ctx: Context) -> None:
    """Rank 0's server key, as a client hands it over (the canonical
    bootstrapping and key-switching keys), broadcast to every rank, each of
    which forms its own key and the impl's key form on its card; returns once
    every rank has."""
    p = ctx.p
    if ctx.rank == 0:
        bk, ksk = ctx.sk.bk_u32.contiguous(), ctx.sk.ksk_u32.contiguous()
    else:
        bk = torch.empty((p.n, p.rows, p.k + 1, p.degree), dtype=torch.int32, device=ctx.device)
        ksk = torch.empty((p.k * p.degree * p.ks_levels, p.n + 1), dtype=torch.int32,
                          device=ctx.device)
    dist.broadcast(bk, src=0)
    dist.broadcast(ksk, src=0)
    if ctx.rank:
        sk = tfhe.server_key_from_numpy(program_params(p), bk, ksk, device=ctx.device)
        ctx.sk = tfhe.with_key_form(sk, ctx.impl)
    dist.barrier()


def _warm(client, header: ranks.Header | None):
    """A warm request, on every rank where there are several."""
    if header is not None:
        header.announce(ranks.WARM)
    return client.serve(client.warm_request())


def _measure(client, seconds: float, trace: bool, device: torch.device, samplers: list,
             header: ranks.Header | None = None):
    """The window, traced or not; returns the served requests, the window's
    seconds, the trace summary (or None) and the SM clocks each of
    ``samplers`` took.  With ``header``, the other ranks are told to stop
    once the window has closed."""
    for sampler in samplers:
        sampler.open()
    served: list[Served] = []
    summary = None
    announce = header.announce if header is not None else None

    def stop():
        if header is not None:
            header.announce(ranks.STOP)

    if trace:  # the window opens once every rank's profiler runs
        with traced(device, before_window=dist.barrier if header is not None else None,
                    after_window=stop) as out:
            window_s = _window(client, served, seconds, device, True, announce)
        summary = out[0]
    else:
        window_s = _window(client, served, seconds, device, False, announce)
        stop()
    for sampler in samplers:
        sampler.close()
    clocks = [sampler.stop() for sampler in samplers]
    return served, window_s, summary, clocks


def _clock_range(clocks: list) -> list | None:
    return [min(clocks), statistics.median(clocks), max(clocks)] if clocks else None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, control: bool = False, marks: dict | None = None,
             group: ranks.Ranks | None = None) -> dict:
    """Run ``cell`` once; return the result line as a dict ("checks" last).
    ``marks`` holds the seconds run.py spent before the call, by part.  A
    cell on more than one card runs with the ranks ``group`` started (or
    starts them here) and ends them before the check."""
    setup = dict(marks or {})
    setup["before_run_s"] = time.perf_counter() - t_start
    impl = cell.workload["control_impl"] if control else cell.workload["impl"]
    log(f"cell {cell.name}: config {cell.config_name}, traffic {cell.traffic_name}, impl {impl}"
        f"{' (control)' if control else ''}, seed {seed}, {seconds} s, trace {int(trace)}")
    if cell.chips > 1:  # spawn_s: starting the ranks (or run.py's part) and opening their store
        t = time.perf_counter()
        if group is None:
            group = ranks.Ranks.start(cell.chips, device.type)
        group.open({"cell": spec.cell_to_json(cell), "seed": seed, "seconds": seconds,
                    "trace": trace, "impl": impl})
        setup["spawn_s"] = setup.get("spawn_s", 0.0) + time.perf_counter() - t
    try:
        return _run_cell(cell, seed, seconds, trace, device, t_start, impl, setup, group)
    finally:
        if group is not None:
            group.abort()


def _run_cell(cell, seed, seconds, trace, device, t_start, impl, setup, group):
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    indices = range(cell.chips) if group is not None else [device.index or 0]
    power_limits, samplers = [], []
    if on_card:
        for index in indices:
            name, power_limit = bcard.name_and_power_limit(index)
            log(f"card: {name}, power limit {power_limit}" if group is None else
                f"card {index}: {name}, power limit {power_limit}")
            power_limits.append(power_limit)
            samplers.append(bcard.ClockSampler(index))
            samplers[-1].start()
    if group is not None:
        group.on_failure.extend(sampler.stop for sampler in samplers)

    ctx, client, header = _set_up(cell, seed, seconds, device, impl, setup, group)
    setup["setup_s"] = time.perf_counter() - t_start
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()))

    served, window_s, summary, card_clocks = _measure(client, seconds, trace, device, samplers,
                                                      header)
    clocks = card_clocks[0] if card_clocks else []
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    guard.check_imports("after the window")
    reports = group.reports() if group is not None else []
    for report in reports:
        if report["forbidden"]:
            log(f"rank {report['rank']}: forbidden modules loaded: "
                + ", ".join(report["forbidden"]))
            raise SystemExit(3)
    latency = sorted((s.t_done - s.t_issue) * 1e3 for s in served)
    latency_ms = {f"p{q}": latency[min(len(latency) - 1, len(latency) * q // 100)]
                  for q in (0, 50, 90, 95, 99)} | {"max": latency[-1]}
    log(f"window: {len(served)} requests in {window_s:.3f} s; latency ms "
        + json.dumps(latency_ms) + "; SM clock "
        + (f"{min(clocks):.0f}-{statistics.median(clocks):.0f}-{max(clocks):.0f} MHz over "
           f"{len(clocks)} samples" if clocks else "not sampled"))

    card_traces = None
    if group is not None and summary is not None:
        card_traces = [summary] + [TraceSummary(**report["trace"]) for report in reports]
        summary = summed(card_traces)
    run = Run(cell=cell, p=ctx.p, card=kind, setup=setup, served=served, window_s=window_s,
              trace=summary, card_traces=card_traces)
    metrics = {}
    for entry in cell.per_layer if trace else cell.end_to_end:
        value = spec.metric_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    # the check: the other ranks end, the program's keys go, then the reference works
    if group is not None:
        group.close()
    ctx.sk = ctx.mesh = None
    client.release_program_state()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    keys = ref.derive_keys(ctx.p, ref.draw_keys(ctx.p, _generator(device, seed)))
    numbers, info, failed = client.check(keys, served, random.Random(seed ^ 0x5EED))
    _sync(device)
    info["check_s"] = time.perf_counter() - t
    correct = all(value <= limit for value, limit in numbers.values())

    world = cell.chips if group is not None else 1
    peaks = [memory_peak] + [report["memory_peak_bytes"] for report in reports]
    result = {"correct": correct, "attempted": len(served), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": world,
                         "memory_peak_bytes": max(peaks)}}
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s / world
        result["device"]["window_s"] = summary.window_s / world
        result["breakdown"] = {"device_ops": summary.top(summary.device_s_by_name),
                               "idle_gaps": summary.top(summary.idle_s_by_host)}
        result["trace_cost"] = (card_traces or [summary])[0].cost_s
        log("device seconds by scope: " + json.dumps(summary.device_s_by_scope))
        log("trace cost: " + json.dumps(summary.cost_s))
    if group is not None:
        result["device"]["cards"] = _cards(indices, [kind] + [r["kind"] for r in reports], peaks,
                                           power_limits, card_clocks, card_traces)
        setup["ranks"] = [report["setup"] for report in reports]
        for card in result["device"]["cards"]:
            log(f"card {card['index']}: " + json.dumps(card))
    result["window"] = {"seconds": window_s, "latency_ms": latency_ms}
    result["card"] = {"power_limit": power_limits[0] if power_limits else None,
                      "sm_clock_samples": len(clocks), "sm_clock_mhz": _clock_range(clocks)}
    result["setup"] = setup
    result["check_info"] = info
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in numbers.items()}
    log("check info: " + json.dumps(info))
    log(f"correct: {str(correct).lower()}; the numbers compared, each with its limit:")
    for name, (value, limit) in numbers.items():
        log(f"check {name}: {value} (limit {limit})")
    return result


def _cards(indices, kinds, peaks, power_limits, clocks, traces) -> list[dict]:
    """Each card's own figures, in rank order."""
    cards = []
    for rank, index in enumerate(indices):
        card = {"index": index, "kind": kinds[rank], "memory_peak_bytes": peaks[rank],
                "power_limit": power_limits[rank] if power_limits else None,
                "sm_clock_samples": len(clocks[rank]) if clocks else 0,
                "sm_clock_mhz": _clock_range(clocks[rank]) if clocks else None}
        if traces is not None:
            card |= {"busy_s": traces[rank].busy_s, "window_s": traces[rank].window_s,
                     "trace_cost": traces[rank].cost_s}
        cards.append(card)
    return cards


def _window(client, served: list, seconds: float, device: torch.device,
            traced_requests: bool, announce=None) -> float:
    """The closed loop: requests one at a time until ``seconds`` have passed;
    returns the seconds from the first issue to the last completion.  With
    ``announce``, each request's index is announced to the other ranks
    first, as part of the request."""
    record = torch.profiler.record_function
    i = 0
    t_open = time.perf_counter()
    deadline = t_open + seconds
    while True:
        request = client.request(i)
        t_issue = time.perf_counter()
        if traced_requests:
            with record(REQUEST):
                if announce is not None:
                    announce(i)
                outputs = client.serve(request)
                _sync(device)
        else:
            if announce is not None:
                announce(i)
            outputs = client.serve(request)
            _sync(device)
        t_done = time.perf_counter()
        served.append(Served(request, t_issue, t_done, client.units(request),
                             tuple(client.pbs_batches(request)), outputs))
        i += 1
        if t_done >= deadline:
            return t_done - t_open


def run_rank(cell: spec.Cell, rank: int, world: int, device: torch.device, store,
             run: dict) -> dict:
    """Rank ``rank`` >= 1 of a cell on ``world`` cards (``ranks.py``): join,
    take rank 0's key, build the client, then serve each request rank 0
    announces until it says stop; returns the rank's report."""
    setup = {}
    p = ref.params_from_config(cell.config_name, cell.config)
    if device.type == "cuda":
        _timed(setup, "cuda_init_s", device,
               lambda: (torch.cuda.set_device(device), torch.zeros(1, device=device)))
    ctx = Context(cell=cell, device=device, seed=run["seed"], p=p, impl=run["impl"], gen=None,
                  lwe_sk=None, rank=rank)
    header = _join(ctx, store, world, setup)
    _timed(setup, "replicate_s", device, lambda: _replicate(ctx))
    client = _timed(setup, "pool_s", device,
                    lambda: spec.client_class(cell.traffic["client"])(ctx))
    for label in ("warm1_s", "warm2_s"):
        _timed(setup, label, device, lambda: _follow_warm(client, header))
    summary = None
    if run["trace"]:
        with traced(device, before_window=dist.barrier) as out:
            requests = _rank_window(client, header, device, True)
        summary = out[0]
    else:
        requests = _rank_window(client, header, device, False)
    on_card = device.type == "cuda"
    return {"rank": rank, "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else 0,
            "requests": requests, "setup": setup,
            "trace": dataclasses.asdict(summary) if summary is not None else None,
            "forbidden": guard.forbidden_modules()}


def _follow_warm(client, header: ranks.Header):
    word = header.receive()
    if word != ranks.WARM:
        raise RuntimeError(f"rank 0 sent {word} where a warm request was due")
    return client.serve(client.warm_request())


def _rank_window(client, header: ranks.Header, device: torch.device,
                 traced_requests: bool) -> int:
    """Every announced request until the stop word; returns how many there
    were."""
    record = torch.profiler.record_function
    count, i = 0, header.receive()
    while i != ranks.STOP:
        if traced_requests:
            with record(REQUEST):
                client.serve(client.request(i))
                _sync(device)
        else:
            client.serve(client.request(i))
            _sync(device)
        count += 1
        i = header.receive()
    return count


def print_result(result: dict) -> None:
    print(json.dumps(result), flush=True)
