# Port copy of karpenter_tpu/api/wellknown.py.
"""Well-known label/annotation/taint vocabulary.

Mirrors the karpenter.sh domain vocabulary consumed throughout the reference
(kwok/ec2/ec2.go:44,890; website/content/en/preview/concepts/nodepools.md,
scheduling.md:383-387) — the three topology keys the scheduler supports, the
capacity-type domain, and the control-flow taints/annotations.
"""

GROUP = "karpenter.sh"

# Labels
NODEPOOL_LABEL = "karpenter.sh/nodepool"
CAPACITY_TYPE_LABEL = "karpenter.sh/capacity-type"
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"
ZONE_LABEL = "topology.kubernetes.io/zone"
REGION_LABEL = "topology.kubernetes.io/region"
HOSTNAME_LABEL = "kubernetes.io/hostname"
ARCH_LABEL = "kubernetes.io/arch"
OS_LABEL = "kubernetes.io/os"
INITIALIZED_LABEL = "karpenter.sh/initialized"
REGISTERED_LABEL = "karpenter.sh/registered"
NODECLASS_LABEL = "karpenter.tpu/nodeclass"
# Per-NodePool solver-backend override (solver/convex.py): "ffd" pins the
# pool to the greedy device kernel, "convex" to the global ADMM backend;
# absent = the operator-level --solver-backend default. Read off NodePool
# metadata by the provisioner, carried on NodePoolSpec.solver_backend.
SOLVER_BACKEND_LABEL = "karpenter.sh/solver-backend"

# The exactly-three topology keys supported for topology spread
# (website/.../scheduling.md:383-387).
TOPOLOGY_KEYS = (ZONE_LABEL, HOSTNAME_LABEL, CAPACITY_TYPE_LABEL)

# Capacity types
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_RESERVED = "reserved"

# Gang (co-scheduling) labels — LABELS, not annotations, deliberately: labels
# ride the pod's solver signature (api/objects._POD_SIG_FIELDS via `meta`), so
# a gang edit invalidates exactly the affected encode-cache runs with no extra
# cache plumbing. A gang is the set of pending pods sharing a GANG_LABEL
# value; GANG_SIZE_LABEL declares the member count the gang needs and
# GANG_MIN_RANKS_LABEL (optional, default = size) the minimum members that
# must place for the gang to commit. GANG_TOPOLOGY_LABEL (optional; one of
# TOPOLOGY_KEYS) asks for rank-aware co-location: members gain a preferred
# self-affinity on that key, relaxed by the ordinary preference ladder.
GANG_LABEL = "scheduling.karpenter.sh/gang"
GANG_SIZE_LABEL = "scheduling.karpenter.sh/gang-size"
GANG_MIN_RANKS_LABEL = "scheduling.karpenter.sh/gang-min-ranks"
GANG_TOPOLOGY_LABEL = "scheduling.karpenter.sh/gang-topology"

# Annotations
DO_NOT_DISRUPT_ANNOTATION = "karpenter.sh/do-not-disrupt"
POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"
NODEPOOL_HASH_ANNOTATION = "karpenter.sh/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION = "karpenter.sh/nodepool-hash-version"
NODECLASS_HASH_ANNOTATION = "karpenter.tpu/nodeclass-hash"

# Taints (key, effect)
UNREGISTERED_TAINT_KEY = "karpenter.sh/unregistered"
DISRUPTED_TAINT_KEY = "karpenter.sh/disrupted"
EFFECT_NO_SCHEDULE = "NoSchedule"
EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
EFFECT_NO_EXECUTE = "NoExecute"

# Restricted label domains a NodePool may not set directly.
RESTRICTED_LABELS = frozenset({NODEPOOL_LABEL, HOSTNAME_LABEL})

# Finalizers
TERMINATION_FINALIZER = "karpenter.sh/termination"
