"""Process-wide model flags (counterpart of ``repro/models/runtime_flags.py``).

``MOE_GROUPS`` and ``MOE_MESH`` steer
:func:`repro_torch.models.moe.moe_ffn` (:func:`set_moe_dispatch` sets
both for a step on a mesh); ``REMAT`` picks the activation
checkpointing of :func:`repro_torch.models.model.forward`'s layer loop
when gradients are being recorded.  The reference's ``UNROLL`` (the
``unroll=`` of its ``lax.scan``s) is left out: the port's layer loop is
a Python loop with no scan to unroll.
"""
#: MoE dispatch groups.  1 = one counting sort over all tokens.  G > 1
#: splits the tokens into G contiguous groups, each with its own stable
#: order and capacity (the paper's thread-private counters); the port
#: sorts all groups in one counting sort of the keys ``g * E + e``.
MOE_GROUPS = 1


def set_moe_groups(g: int):
    global MOE_GROUPS
    MOE_GROUPS = g


def moe_groups() -> int:
    return MOE_GROUPS


#: explicit mesh dispatch.  When set to a ``(mesh, dp_axes)`` tuple,
#: ``moe_ffn`` routes dispatch and combine through
#: :func:`repro_torch.models.moe.moe_ffn_shardmap` with one token group
#: per data shard.  None = the group path.
MOE_MESH = None


def set_moe_mesh(mesh, dp_axes=("data",)):
    global MOE_MESH
    MOE_MESH = None if mesh is None else (mesh, tuple(dp_axes))


def moe_mesh():
    return MOE_MESH


def set_moe_dispatch(cfg, mesh, global_batch: int) -> int:
    """The MoE dispatch of a step on ``mesh`` with ``global_batch`` rows,
    as the reference's dry run sets it (``build_lowered``): one token
    group a data shard and the mesh's dispatch on each shard's tokens
    when ``cfg`` is a MoE and the rows divide over the data axes, else
    one group and no mesh.  Returns the groups: a one-process run that
    is to match sets ``set_moe_groups`` to them."""
    from ..launch.mesh import batch_axes, dp_size

    if mesh is not None and cfg.is_moe and \
            global_batch % dp_size(mesh) == 0:
        set_moe_groups(dp_size(mesh))
        set_moe_mesh(mesh, batch_axes(mesh))
        return dp_size(mesh)
    set_moe_groups(1)
    set_moe_mesh(None)
    return 1


#: activation checkpointing of the layer loop, applied only while autograd
#: records (``torch.is_grad_enabled()``):
#: "full" = every block recomputed in the backward
#:          (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)
#: "dots" = the outputs of ``aten.mm`` saved, the rest recomputed (the
#:          reference's ``dots_with_no_batch_dims_saveable``: the batched
#:          expert and attention einsums are recomputed)
REMAT = "full"


def set_remat(v: str):
    global REMAT
    REMAT = v


def remat() -> str:
    return REMAT
