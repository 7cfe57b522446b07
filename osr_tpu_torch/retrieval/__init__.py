"""Query encoding, the sparse search engine and result assembly."""
