"""Fleet: the hybrid attention + SSD pipeline (flash_attention ->
ssd_scan), explored on the measured CUDA backend and the analytical one."""

from .pipeline import (FLASH_D, FLASH_HEADS, FLASH_S, SSD_MAX_HEADS, SSD_N,
                       SSD_P, SSD_S, default_measurement_path,
                       flash_grid_steps, flash_vmem_bytes,
                       fleet_cuda_components, fleet_cuda_oracle,
                       fleet_cuda_parity_cases, fleet_cuda_session,
                       fleet_knob_spaces, fleet_session, fleet_tmg,
                       fleet_xla_tool, ssd_grid_steps, ssd_vmem_bytes)

__all__ = [
    "FLASH_S", "FLASH_D", "FLASH_HEADS", "SSD_S", "SSD_P", "SSD_N",
    "SSD_MAX_HEADS", "fleet_tmg", "fleet_knob_spaces", "fleet_xla_tool",
    "flash_vmem_bytes", "flash_grid_steps", "ssd_vmem_bytes",
    "ssd_grid_steps", "fleet_cuda_components", "fleet_cuda_parity_cases",
    "fleet_cuda_oracle", "fleet_cuda_session", "fleet_session",
    "default_measurement_path",
]
