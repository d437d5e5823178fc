from .strtab import MatchTables, StringTable

__all__ = ["MatchTables", "StringTable"]
