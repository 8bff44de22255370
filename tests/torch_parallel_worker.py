"""Worker for tests/test_torch_parallel.py: one process of a two-process
gloo group on the CPU, each process holding two shards of a four-shard
mesh (the port's counterpart of tests/dist_worker.py). It imports no JAX.

    python tests/torch_parallel_worker.py RANK STORE OUT

joins the group through the file store STORE, renders the Cornell box
on the scan driver and the atmosphere on the lane pool sharded over the
mesh, takes sharded_film's value+grad of __graft_entry__.py's loss with
respect to the spectra and one Adam step, and saves the results to OUT
(torch.save)."""

import sys

import torch


def main():
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    from eradiate_kernel_tpu_torch.films import develop
    from eradiate_kernel_tpu_torch.parallel import (init_distributed,
                                                    make_mesh, render_sharded,
                                                    sharded_film)
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils import autodiff
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere, cornell_box

    init_distributed(f"file://{store}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh(["cpu", "cpu"])
        res = {"size": mesh.size, "shards": [k for k, _ in mesh.shards()]}
        box = load_dict(cornell_box(8, 8, 8, 3), device="cpu")
        res["box"] = render_sharded(box, mesh, seed=9, develop_film=False)
        d = atmosphere(8, 8, 4, 6)
        d["surface"]["to_world"][1]["value"] = [0.5, 0.5, -1e-3]
        res["atmosphere"] = render_sharded(
            load_dict(d, device="cpu"), mesh, seed=3, regen=True,
            regen_lanes=16, develop_film=False)

        pm = autodiff.traverse(load_dict(cornell_box(8, 8, 4, 3),
                                         device="cpu"))
        pm.keep(["spectra.baked.value"])
        opt = autodiff.Adam(pm.trainable(), lr=1e-2)
        film = sharded_film(pm.with_trainable(opt.params), mesh, 0, 4)
        loss = torch.mean(develop(film, "rgb") ** 2)
        opt.zero_grad()
        loss.backward()
        res["loss"] = loss.detach()
        res["grad"] = opt.params["spectra.baked.value"].grad.clone()
        opt.step()
        res["stepped"] = opt.params["spectra.baked.value"].detach().clone()
        torch.save(res, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
