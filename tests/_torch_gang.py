"""Gangs of ranks for the distributed tests: ``run_gang(fn, world,
tmp_path)`` starts ``world`` spawned processes, each of which sets one
intra-op thread, starts a gloo process group through a ``file://``
store under ``tmp_path`` (so parallel test workers never race for a
port), runs ``fn(rank, world, *args)`` and hands back its (picklable)
result. A wall limit kills every child and fails the test, so a
collective one rank never reaches cannot hang the run. ``fn`` must live
in a module that imports torch and the port only
(``_torch_dist_cases``): a child imports it anew."""
import queue
import traceback

import torch.multiprocessing as mp


def _entry(fn, rank, world, store, q, args):
    import torch

    torch.set_num_threads(1)
    from bigdl_tpu_torch.utils import engine
    try:
        engine.init_distributed("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank, timeout_s=120)
        q.put((rank, "ok", fn(rank, world, *args)))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        engine.shutdown()


def run_gang(fn, world, tmp_path, *args, timeout=240):
    """``{rank: fn's result}``; raises AssertionError naming the rank
    and its traceback when a rank fails, or when the wall limit
    passes."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = tmp_path / f"store-{fn.__name__}"
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(store), q, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(world):
            rank, kind, value = q.get(timeout=timeout)
            (results if kind == "ok" else errors)[rank] = value
            if errors:
                break
    except queue.Empty:
        raise AssertionError(
            f"gang {fn.__name__}: no result from ranks "
            f"{sorted(set(range(world)) - set(results))} within "
            f"{timeout}s") from None
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        rank = min(errors)
        raise AssertionError(f"rank {rank} of {fn.__name__} failed:\n"
                             f"{errors[rank]}")
    return results
