"""Host index stack: tokenizer, hybrid layout, builder and postings tail."""
