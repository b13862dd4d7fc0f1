from .engine import EngineInputs, build_inputs, run_engine
from .faults import FaultSchedule, FaultSpec, compile_schedule
from .simulator import BHFLSimulator, RunResult

__all__ = ["BHFLSimulator", "EngineInputs", "FaultSchedule", "FaultSpec",
           "RunResult", "build_inputs", "compile_schedule", "run_engine"]
