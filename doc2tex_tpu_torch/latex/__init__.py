from .normalize import normalize_formula, tokenize_formula, normalize_file
from .extract import find_math
from .demacro import pydemacro
from .postprocess import (
    Postprocessing,
    remove_redundant_bracket,
    standardize_whitespace,
    remove_redundant_array_env,
)

__all__ = [
    "normalize_formula",
    "tokenize_formula",
    "normalize_file",
    "find_math",
    "pydemacro",
    "Postprocessing",
    "remove_redundant_bracket",
    "standardize_whitespace",
    "remove_redundant_array_env",
]
