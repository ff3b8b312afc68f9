"""One rank of the four-process gloo group that ``test_torch_parallel.py``
spawns; it holds no test of its own.

    python tests/test_torch_parallel_worker.py RANK WORLD PORT DIR

reads ``DIR/inputs.pt`` (written by the test), runs every sharded function
of ``sponge_tpu_torch.parallel`` on this rank's slice, and writes what it
got to ``DIR/rank{RANK}.pt``.  It imports neither JAX nor the test's
conftest.
"""

import sys
from pathlib import Path

import torch


def catch(kind, fn):
    """The message of the ``kind`` exception ``fn`` raises, else None."""
    try:
        fn()
    except kind as e:
        return str(e) or type(e).__name__
    return None


def run(rank: int, world: int, port: int, out_dir: Path) -> dict:
    from sponge_tpu_torch.parallel import (
        batch_sharding,
        leaf_sharding,
        make_mesh,
        multihost,
        replicated,
        sharded,
        sharded_merkle_root,
        sharded_merkle_root_jive,
        sharded_merkle_root_wide,
        sharded_merkle_verify_batch,
        sharded_permute_fn,
        sharded_state,
        sharded_transcript_fn,
    )

    inp = torch.load(out_dir / "inputs.pt", weights_only=False)
    cfg, cfg4 = inp["cfg"], inp["cfg4"]
    multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank, device_type="cpu")
    mesh = multihost.global_mesh()

    def mine(plane):
        n = plane.shape[-1] // world
        return plane[..., rank * n : (rank + 1) * n].contiguous()

    res = {
        "mesh": (mesh.device_type, mesh.mesh_dim_names, mesh.size(), mesh.get_local_rank()),
        "placements": (batch_sharding(mesh), leaf_sharding(mesh), replicated(mesh)),
        "permute": sharded_permute_fn(cfg, mesh)(mine(inp["state"])),
        "state": sharded_state(cfg, mesh, inp["state"].shape[-1]),
        "transcript": sharded_transcript_fn(cfg, inp["steps"], mesh)(mine(inp["elems"])),
        "root": sharded_merkle_root(cfg, mine(inp["leaves"]), mesh),
        "edge_root": sharded_merkle_root(cfg, mine(inp["edge_leaves"]), mesh),
        "wide_root": sharded_merkle_root_wide(cfg, mine(inp["wide_leaves"]), mesh),
        "jive_root": sharded_merkle_root_jive(cfg4, mine(inp["jive_leaves"]), mesh),
        "verify": sharded_merkle_verify_batch(
            cfg, inp["root"], mine(inp["proof_leaves"]), mine(inp["paths"]), mine(inp["indices"]), mesh
        ),
    }
    leaves = inp["leaves"]
    res["errors"] = {
        "uneven_chunks": catch(ValueError, lambda: sharded_merkle_root(
            cfg, leaves[:, : 4 if rank == 0 else 2], mesh)),
        "not_power_of_two": catch(ValueError, lambda: sharded_merkle_root(cfg, leaves[:, :3], mesh)),
        "index_out_of_range": catch(IndexError, lambda: sharded_merkle_verify_batch(
            cfg, inp["root"], mine(inp["proof_leaves"]), mine(inp["paths"]),
            mine(inp["indices"]) + (1 << inp["paths"].shape[0]), mesh)),
        "indivisible_batch": catch(ValueError, lambda: sharded_state(cfg, mesh, 18)),
        "transcript_rows": catch(ValueError, lambda: sharded_transcript_fn(cfg, inp["steps"], mesh)(
            mine(inp["elems"])[1:])),
        "sub_mesh": catch(ValueError, lambda: make_mesh(world - 1, device_type="cpu")),
        "cuda_mesh_on_gloo": catch((RuntimeError, ValueError), lambda: make_mesh()),
        "initialize_twice": catch(RuntimeError, lambda: multihost.initialize(device_type="cpu")),
        "odd_width_jive": catch(ValueError, lambda: sharded_merkle_root_jive(cfg, mine(inp["wide_leaves"]), mesh)),
    }
    res["report"] = multihost.scaling_report(cfg, inp["batch_per_device"], reps=1)

    if rank == 1:  # corrupt one rank's permutation: every rank must refuse to report
        honest = sharded.sharded_permute_fn

        def corrupted(cfg_, mesh_, backend="auto"):
            fn = honest(cfg_, mesh_, backend)
            return lambda local: torch.cat([fn(local)[..., :1] ^ 1, fn(local)[..., 1:]], dim=-1)

        sharded.sharded_permute_fn = corrupted
    res["refused"] = catch(RuntimeError, lambda: multihost.scaling_report(cfg, inp["batch_per_device"], reps=1))
    res["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sponge_tpu", "conftest"))
    return res


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out_dir = Path(sys.argv[4])
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        res = run(rank, world, port, out_dir)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(res, out_dir / f"rank{rank}.pt")


if __name__ == "__main__":
    main()
