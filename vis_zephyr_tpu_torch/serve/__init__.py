"""Generation, the chat engine and its HTTP and CLI surfaces."""
