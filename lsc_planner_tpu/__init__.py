"""lsc_planner_tpu: batched swarm trajectory-optimization framework.

A from-scratch JAX/XLA re-design of the capabilities of
qwerty35/lsc_planner (RA-L 2022 "Online Distributed Trajectory Planning for
Quadrotor Swarm with Feasibility Guarantee using Linear Safe Corridor").

The reference plans N quadrotors sequentially on CPU with per-agent CPLEX
QPs; here every stage of the receding-horizon cycle -- obstacle prediction,
initial trajectories, priority goal planning, LSC/BVC/SFC constraint
construction, and the trajectory QP -- is a batched tensor program over the
agent axis, sharded across GPUs with jax collectives replacing the
reference's ROS message exchange.
"""

from .config import (Param, PlannerMode, PredictionMode, InitialTrajMode,
                     SlackMode, GoalMode, PlannerState, PlanningReport)
from .missions import (Mission, AgentSpec, ObstacleSpec, load_mission,
                       make_circle_mission, make_square_mission,
                       make_random_mission)

__version__ = "0.1.0"
