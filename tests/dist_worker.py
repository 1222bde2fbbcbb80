"""Worker process for tests/test_dist.py: one host of a 2-process
distributed mapping session over a 2x4 virtual CPU mesh.

Builds ONLY its own shards' sub-indexes (4 of 8), joins the global mesh
via jax.distributed, maps the shared read set with parallel.dist
DistMapper, and writes the SAM bytes + timing to the given output path.
Run: python dist_worker.py <pid> <nprocs> <port> <out_path>
"""
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

# device-count/collectives config must precede ANY backend touch, and
# importing shrimp_tpu initializes one — so configure jax first
import jax  # noqa: E402
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    pid = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    port = int(sys.argv[3])
    out_path = sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "unpaired"

    # join the cluster before importing shrimp_tpu (whose import chain
    # touches the XLA backend)
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nprocs, process_id=pid)
    from shrimp_tpu.parallel.dist import DistMapper

    import numpy as np
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.core import encode
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.io.fasta import SeqRecord

    from test_dist import (make_cs_dataset_dist, make_cs_paired_dataset,
                           make_dataset, make_paired_dataset)
    import shrimp_tpu.constants as C

    cs = mode in ("cs", "cs-paired")
    rs = mode.startswith("rs")
    if rs:
        mode = {"rs": "unpaired", "rs-paired": "paired"}[mode]
    if mode == "long":
        from test_dist import make_long_dataset
        contigs, reads = make_long_dataset()
        cfg = MapperConfig(longest_read_len=1000)
        mode = "unpaired"
    elif mode == "paired":
        contigs, reads = make_paired_dataset()
        cfg = MapperConfig(pair_mode="opp-in", min_insert_size=60,
                           max_insert_size=240)
    elif mode == "cs":
        contigs, reads = make_cs_dataset_dist()
        cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE)
    elif mode == "cs-paired":
        contigs, reads = make_cs_paired_dataset()
        cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE, pair_mode="opp-in")
    else:
        contigs, reads = make_dataset()
        cfg = MapperConfig()
    D = 8
    d_local = D // nprocs
    shard_meta = [dict(names=[contigs[d][0]],
                       lengths=np.array([len(contigs[d][1])], np.uint32))
                  for d in range(D)]
    lo = pid * d_local
    if cs:
        local_subs = [build_index([contigs[d]], default_seeds(mode="cs"),
                                  mode="cs")
                      for d in range(lo, lo + d_local)]
    else:
        local_subs = [build_index([contigs[d]], default_seeds())
                      for d in range(lo, lo + d_local)]

    dm = DistMapper(shard_meta, local_subs, cfg)
    if mode in ("paired", "cs-paired"):
        sam = dm.map_paired_sam(reads, batch_size=100,
                                read_sharding=rs)
        zmax = (float(np.max(dm.last_zpair_merged[:, 3]))
                if dm.last_zpair_merged is not None else 0.0)
    else:
        sam = dm.map_unpaired_sam(reads, batch_size=100,
                                  read_sharding=rs)
        zmax = (float(np.max(dm.last_z1_merged))
                if dm.last_z1_merged is not None else 0.0)
    with open(out_path, "wb") as f:
        f.write(sam)
    with open(out_path + ".meta", "w") as f:
        json.dump({"wall": dm.last_wall, "z1_max": zmax,
                   "slice_jobs": dm.last_slice_jobs,
                   "f1_local_windows": dm.last_f1_local_windows,
                   "render_wall": dm.last_render_wall,
                   "merge_bytes": dm.merge_bytes,
                   "merge_secs": dm.merge_secs,
                   "n_reads": len(reads)}, f)
    print(f"worker {pid}: done, {len(sam)} bytes", flush=True)


if __name__ == "__main__":
    main()
