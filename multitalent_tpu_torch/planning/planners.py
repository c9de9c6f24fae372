"""Planner names -> classes: the names plan_and_preprocess's -pl3d / -pl2d
take, with the reference's class names as aliases.

The port's plain table in place of the JAX package's registry of planners
(multitalent_tpu/registry.py PLANNERS, resolve_planner); it imports the
planners only, never the trainers.
"""
from __future__ import annotations

from multitalent_tpu_torch.planning import experiment_planner as ep
from multitalent_tpu_torch.planning import multitalent_planner as mp

_ALIASES = {
    ep.ExperimentPlannerBase: ("ExperimentPlanner",),
    ep.ExperimentPlanner3Dv21: ("ExperimentPlanner3D_v21",),
    ep.ExperimentPlanner2Dv21: ("ExperimentPlanner2D_v21",),
    ep.ExperimentPlannerResencV21: ("ExperimentPlanner3DFabiansResUNet_v21",),
    ep.ExperimentPlanner11GB: ("ExperimentPlanner3D_v21_MemoryTarget",
                               "ExperimentPlanner3D_v21_11GB"),
    ep.ExperimentPlanner32GB: ("ExperimentPlanner3D_v21_32GB",),
    ep.ExperimentPlanner3ConvPerStage: ("ExperimentPlanner3D_v21_3convperstage",),
    ep.ExperimentPlanner16GB: ("ExperimentPlanner3D_v21_16GB",),
    ep.ExperimentPlanner3Dv22: ("ExperimentPlanner3D_v22",),
    ep.ExperimentPlanner3Dv23: ("ExperimentPlanner3D_v23",),
    ep.ExperimentPlannerCT2: (),
    ep.ExperimentPlannerNonCT: ("ExperimentPlannernonCT",),
    ep.ExperimentPlannerAnisoAxisSpacing: ("ExperimentPlannerTargetSpacingForAnisoAxis",),
    ep.ExperimentPlannerTrgSp2x2x2: ("ExperimentPlanner3D_v21_customTargetSpacing_2x2x2",),
    ep.ExperimentPlannerNoResampling: ("ExperimentPlanner3D_v21_noResampling",),
    ep.ExperimentPlannerAllConv3x3: (),
    ep.ExperimentPlannerPoolBasedOnSpacing: (),
    mp.MultiTalentPlanner: ("ExperimentPlanner3D_v21_MultiTalent",),
    mp.PretrainedPlanner: ("ExperimentPlanner3D_v21_Pretrained",
                           "ExperimentPlanner3D_v21_Pretrained_MultiTalent"),
}

PLANNERS = {name: cls for cls, aliases in _ALIASES.items()
            for name in (cls.__name__, *aliases)}


def resolve_planner(name: str) -> type:
    if name not in PLANNERS:
        raise KeyError(f"Unknown planner {name!r}. Registered: {sorted(PLANNERS)}")
    return PLANNERS[name]
