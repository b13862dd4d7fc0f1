from .engine import (AGG_SEL, AGGREGATORS, SHARED_DATA_FIELDS, EngineCarry,
                     EngineInputs, build_inputs, init_engine_carry,
                     run_engine, run_engine_chunk)
from .faults import FaultSchedule, FaultSpec, compile_schedule
from .population import DevicePopulation, PopulationSpec, as_population
from .simulator import BHFLSimulator, RunResult, run_comparison
from .sweep import (SweepBucket, SweepPlan, SweepResult, execute_plan,
                    plan_sweep, run_plan, run_sweep)

__all__ = ["AGG_SEL", "AGGREGATORS", "BHFLSimulator", "DevicePopulation",
           "EngineCarry", "EngineInputs", "FaultSchedule", "FaultSpec",
           "PopulationSpec", "RunResult",
           "SHARED_DATA_FIELDS", "SweepBucket", "SweepPlan", "SweepResult",
           "as_population", "build_inputs", "compile_schedule", "execute_plan",
           "init_engine_carry", "plan_sweep", "run_comparison", "run_engine",
           "run_engine_chunk", "run_plan", "run_sweep"]
