"""Elastic rescaling: move a training state between meshes.

Counterpart of src/repro/train/elastic.py (`shardings_for`,
`reshard_state`, `resume_on_new_mesh`, `fit_spec_to_mesh`).  A job that
loses devices (or gains them back) builds the mesh its devices support
and resumes: from a checkpoint, whose leaves are stored whole
(`train/checkpoint.py`), so restore is placement-agnostic, or live.

JAX's arrays carry their placement and `device_put` moves them; here a
rank holds plain blocks, so the live rescale names both placements:
`reshard_state` gathers every leaf on the old mesh (a collective of its
ranks) and keeps the new mesh's block.  A new mesh over fewer devices is a
`mesh.sub_mesh` of the old one's ranks; a rank outside it passes None for
the new placements and gets None back.  Parameters and optimizer state
are placement-invariant data, so training continues identically up to the
summation order of the batch-sharded reductions.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.distributed.sharding import (P, NamedSharding, _keep,
                                              gather_full, is_sharding,
                                              local_shard, spec_map)


def shardings_for(mesh, spec_tree: Any) -> Any:
    return spec_map(lambda s: NamedSharding(mesh, s), spec_tree)


def reshard_state(state: Any, new_shardings: Any,
                  old_shardings: Any = None) -> Any:
    """Live rescale: every leaf gathered under `old_shardings` (None: the
    leaves are whole already) and cut to this rank's block under
    `new_shardings` (None: this rank is not in the new mesh, and gets
    None)."""
    if old_shardings is not None:
        state = spec_map(lambda sh, x: gather_full(x, sh.mesh, sh.spec),
                         old_shardings, state, is_leaf=is_sharding)
    if new_shardings is None:
        return None
    return spec_map(lambda sh, x: local_shard(x, sh.mesh, sh.spec).clone(),
                    new_shardings, state, is_leaf=is_sharding)


def resume_on_new_mesh(ckpt_dir: str, like: Any, new_mesh, spec_tree: Any,
                       step: Optional[int] = None) -> Any:
    """Checkpoint-mediated rescale (the crash-recovery path)."""
    from repro_torch.train import checkpoint as ckpt

    return ckpt.restore(ckpt_dir, like, step=step,
                        shardings=shardings_for(new_mesh, spec_tree))


def fit_spec_to_mesh(spec_tree: Any, mesh) -> Any:
    """Drop the axes the new mesh does not have (e.g. 'pod' after losing
    one)."""
    names = set(mesh.axis_names)
    return spec_map(lambda s: P(*(_keep(e, lambda a: a in names)
                                  for e in s)), spec_tree)
