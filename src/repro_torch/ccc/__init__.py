"""The CCC strategy (paper Algorithm 1): the P2.1 solvers, the
cutting-point MDP, the DDQN and its drivers -- the port of
``repro.ccc``."""
from repro_torch.ccc.convex import (AllocationResult,  # noqa: F401
                                    BatchedAllocationResult,
                                    latency_fixed_alloc, p21_feasible_at,
                                    solve_p21, solve_p21_batched)
from repro_torch.ccc.ddqn import BatchedDDQNAgent, DDQNAgent, DDQNConfig  # noqa: F401
from repro_torch.ccc.env import (BatchedCuttingPointEnv,  # noqa: F401
                                 CuttingEnvConfig, CuttingPointEnv,
                                 cnn_env_config)
from repro_torch.ccc.strategy import run_algorithm1, run_algorithm1_batched  # noqa: F401
