"""The port's CUDA sources as files, with no JAX and no kernel build: every
quoted include names a file in ``csrc``, every header there is reached by
some kernel of ``gnn_trunk.KERNELS``, and every source is one of them."""
from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk


def test_csrc_includes_resolve_and_every_file_is_built():
    csrc = gnn_trunk.CSRC
    files = sorted(f for f in csrc.iterdir() if f.suffix in (".cu", ".cuh"))
    for f in files:
        for inc in gnn_trunk._INCLUDE.findall(f.read_bytes()):
            assert (csrc / inc.decode()).is_file(), f"{f.name} includes a missing {inc.decode()}"
    assert {f.stem for f in files if f.suffix == ".cu"} == set(gnn_trunk.KERNELS)
    reached = {h for name in gnn_trunk.KERNELS for h in gnn_trunk.include_closure(name)}
    orphans = {f.name for f in files if f.suffix == ".cuh"} - reached
    assert not orphans, f"headers no kernel reaches: {sorted(orphans)}"
