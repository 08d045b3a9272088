from . import constants
from .config import (Config, End2EndConfig, MatchConfig, MATCH_PRESETS,
                     PAEConfig, ResyncConfig, TrainConfig, VQVAEConfig,
                     load_config)
from .schemas import (CodebookSignature, DatabaseBundle, load_codes,
                      load_result, load_wavlm, load_wavvq, save_codes,
                      save_result, save_wavlm, save_wavvq)

__all__ = [
    "constants", "Config", "End2EndConfig", "MatchConfig", "MATCH_PRESETS",
    "PAEConfig", "ResyncConfig", "TrainConfig", "VQVAEConfig", "load_config",
    "CodebookSignature", "DatabaseBundle", "load_codes", "load_result",
    "load_wavlm", "load_wavvq", "save_codes", "save_result", "save_wavlm",
    "save_wavvq",
]
