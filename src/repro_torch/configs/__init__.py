from .bhfl_cnn import DEFAULT, REDUCED, BHFLSetting

__all__ = ["BHFLSetting", "DEFAULT", "REDUCED"]
