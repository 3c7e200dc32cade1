"""Multi-device SpMV and CG over ``torch.distributed``: the counterpart of
``ellspmv_tpu.parallel``. `mesh` places the ranks, `launch` spawns them,
`spmv` and `stream` shard the matrices and run the multiply in each rank,
`solver` runs CG over them, and `dryrun` checks the whole path once."""
