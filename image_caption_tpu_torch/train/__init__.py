"""XE and focal training of the caption model."""
