"""The Streamlit app, on the card (``streamlit_app``); streamlit is
imported only when it runs.

Run with:  streamlit run rgnir_torch/app/streamlit_app.py
"""
