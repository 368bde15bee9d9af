from .plan import (  # noqa: F401
    AggregationNode, DistinctNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanAgg, PlanNode, ProjectNode, SemiJoinNode, SortKeySpec,
    SortNode, TableScanNode, TopNNode, UnionNode, ValuesNode,
)
from .planner import plan_query  # noqa: F401
