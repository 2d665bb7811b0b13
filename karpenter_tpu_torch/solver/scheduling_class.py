# Port copy of karpenter_tpu/solver/scheduling_class.py (only the two ordering flags).
"""Scheduling-class ordering knobs read by provisioning.scheduler._class_keys.

Only the flags are carried over: the class-aware passes (preemption, gangs)
are not part of the port yet."""

PRIORITY_ENABLED = True
GANG_ENABLED = True
