"""The paper's own experimental settings (§6.1, appendix C).

Setting I: 100 clients, 10% participation.  Setting II: 500 clients, 2%
participation.  Dirichlet(0.6) label skew for the non-IID split.
"""
from dataclasses import replace

from repro_torch.configs.base import FedConfig

# --- paper-faithful settings (as published) ---
SETTING_I = FedConfig(
    algo="fedcm",
    num_clients=100,
    cohort_size=10,
    participation="bernoulli",  # "each client is activated independently" (§6.1)
    local_steps=50,  # 5 local epochs x (500 pts / 50 batch) = 50 steps
    alpha=0.1,
    eta_l=0.1,
    eta_g=1.0,
    eta_l_decay=0.998,
    weight_decay=1e-3,
    rounds=4000,
)

SETTING_II = replace(
    SETTING_I,
    num_clients=500,
    cohort_size=10,  # 2% of 500
    local_steps=10,  # 5 local epochs x (100 pts / 50 batch)
    alpha=0.05,
)

DIRICHLET_ALPHA = 0.6  # the paper's non-IID concentration

# --- the scaled settings the CLI defaults follow ---
SCALED_I = replace(SETTING_I, local_steps=10, rounds=300)
SCALED_II = replace(SETTING_II, local_steps=10, rounds=300)
