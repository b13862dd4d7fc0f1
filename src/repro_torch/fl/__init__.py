from .engine import (AGGREGATORS, EngineCarry, EngineInputs, build_inputs,
                     init_engine_carry, run_engine, run_engine_chunk)
from .faults import FaultSchedule, FaultSpec, compile_schedule
from .simulator import BHFLSimulator, RunResult, run_comparison

__all__ = ["AGGREGATORS", "BHFLSimulator", "EngineCarry", "EngineInputs",
           "FaultSchedule", "FaultSpec", "RunResult", "build_inputs",
           "compile_schedule", "init_engine_carry", "run_comparison",
           "run_engine", "run_engine_chunk"]
