from .database import (MatchDatabase, stage_database, stage_test_audio,
                       stage_test_context)
from .engine import CodeKNNEngine
from .oracle import CodeKNNOracle, OracleResult

__all__ = ["MatchDatabase", "stage_database", "stage_test_audio",
           "stage_test_context", "CodeKNNEngine", "CodeKNNOracle",
           "OracleResult"]
